"""Multi-device tests: sharded training numerics match single-device.

The reference has no distributed layer (SURVEY.md section 2.3); these tests
pin this package's addition: DP and DPxTP sharded training steps produce the
same numbers as the unsharded computation, with XLA inserting the
collectives. Runs on the 8 virtual CPU devices from conftest.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
from flax import linen as nn

from dau_convnet.nn import DAUConv2d
from dau_convnet.parallel import (
    batch_sharding,
    init_sharded,
    make_mesh,
    make_train_step,
    param_shardings,
)


class TinyDAUNet(nn.Module):
    engine: str = "xla"

    @nn.compact
    def __call__(self, x):
        x = DAUConv2d(filters=8, dau_units=(2, 1), max_kernel_size=9,
                      use_bias=False, engine=self.engine)(x)
        x = nn.relu(x)
        x = x.mean(axis=(2, 3))
        return nn.Dense(4)(x)


def _data(batch=8):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((batch, 3, 8, 8)), jnp.float32)
    y = jnp.asarray(rng.integers(0, 4, (batch,)))
    return x, y


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("engine", ["xla", "fourier"])
@pytest.mark.parametrize("model_par", [1, 2], ids=["dp", "dp_x_tp"])
def test_sharded_step_matches_single_device(model_par, engine):
    model = TinyDAUNet(engine=engine)
    x, y = _data()
    tx = optax.sgd(0.1)

    # single-device ground truth
    params0 = model.init(jax.random.PRNGKey(0), x)

    @jax.jit
    def step_single(params, x, y):
        def loss_fn(p):
            logits = model.apply(p, x)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return loss, grads

    loss_ref, grads_ref = step_single(params0, x, y)

    # sharded
    mesh = make_mesh(jax.devices()[:8], model=model_par)
    state, sh = init_sharded(model, tx, mesh, x, rng=jax.random.PRNGKey(0))
    step = make_train_step(model, tx, mesh, sh, donate=False)
    state1, loss_sh = step(state, x, y)

    np.testing.assert_allclose(float(loss_sh), float(loss_ref),
                               rtol=2e-5, atol=2e-6)

    # one more step must also agree with the single-device optimizer path
    opt_state = tx.init(params0)
    updates, _ = tx.update(grads_ref, opt_state)
    params1_ref = optax.apply_updates(params0, updates)
    for k in ("weights", "mu1", "mu2"):
        a = np.asarray(state1.params["DAUConv2d_0"][k])
        b = np.asarray(params1_ref["params"]["DAUConv2d_0"][k])
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_param_shardings_shard_f_axis():
    mesh = make_mesh(jax.devices()[:8], model=2)
    model = TinyDAUNet()
    x, _ = _data()
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    sh = param_shardings(params, mesh)
    dau_w = sh["params"]["DAUConv2d_0"]["weights"]
    assert dau_w.spec == ("model",) or tuple(dau_w.spec) == (None, None, None, "model")
    sigma = sh["params"]["DAUConv2d_0"]["sigma"]
    assert tuple(sigma.spec) == ()


def test_opt_shardings_keyed_by_tree_path():
    """Two same-shaped params with DIFFERENT shardings must keep their own
    sharding in the optimizer slots (a (shape, dtype)-keyed map would
    silently alias the second onto the first's sharding)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dau_convnet.parallel.train import _opt_shardings

    mesh = make_mesh(jax.devices()[:8], model=2)
    params = {
        "a": {"kernel": jnp.ones((4, 8))},   # sharded on model (F axis)
        "b": {"scale": jnp.ones((4, 8))},    # same shape, replicated
    }
    p_sh = param_shardings(params, mesh)
    assert tuple(p_sh["a"]["kernel"].spec) == (None, "model")
    assert tuple(p_sh["b"]["scale"].spec) == ()

    tx = optax.sgd(0.1, momentum=0.9)  # trace slot mirrors params tree
    opt_state = tx.init(params)
    opt_sh = _opt_shardings(opt_state, params, p_sh, mesh)
    trace = opt_sh[0].trace
    assert tuple(trace["a"]["kernel"].spec) == (None, "model")
    assert tuple(trace["b"]["scale"].spec) == ()
    # non-params-like leaves (if any) replicate; adam's count does
    tx2 = optax.adam(1e-3)
    opt2 = tx2.init(params)
    opt_sh2 = _opt_shardings(opt2, params, p_sh, mesh)
    assert tuple(opt_sh2[0].count.spec) == ()
    assert tuple(opt_sh2[0].mu["a"]["kernel"].spec) == (None, "model")
    assert tuple(opt_sh2[0].nu["b"]["scale"].spec) == ()

    # the shardings must actually be placeable on the opt state
    placed = jax.device_put(opt2, opt_sh2)
    assert isinstance(
        jax.tree_util.tree_leaves(placed)[0].sharding, NamedSharding)
    del P


def test_batch_sharding_places_batch_on_data_axis():
    mesh = make_mesh(jax.devices()[:8], model=1)
    x, _ = _data(batch=8)
    xs = jax.device_put(x, batch_sharding(mesh))
    assert xs.sharding.spec[0] == "data"


@pytest.mark.parametrize("engine", ["xla", "fourier"])
def test_spatial_sharding_matches_single_device(engine):
    """H-axis sharding of the DAU conv: XLA SPMD inserts the halo exchanges
    for the blur + aggregation convolutions (cross-chip analogue of the
    reference's intra-GPU patch decomposition). For the fourier engine the
    DFT matmuls contract the sharded H axis (SPMD gathers it)."""
    from dau_convnet.ops import DAUConvSettings, dau_conv2d_op
    from dau_convnet.parallel import spatial_sharding

    rng = np.random.default_rng(0)
    S, G, F = 3, 2, 4
    x = jnp.asarray(rng.random((2, S, 64, 16)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((1, S, G, F)) * 0.1, jnp.float32)
    mu1 = jnp.asarray(rng.uniform(-3, 3, (1, S, G, F)), jnp.float32)
    mu2 = jnp.asarray(rng.uniform(-3, 3, (1, S, G, F)), jnp.float32)
    sig = jnp.full((1, S, G, F), 0.5, jnp.float32)
    cfg = DAUConvSettings(kernel_size=9, engine=engine)

    y_ref = jax.jit(lambda *a: dau_conv2d_op(cfg, *a))(x, w, mu1, mu2, sig)

    mesh = make_mesh(jax.devices()[:8], model=1)
    sh = spatial_sharding(mesh)
    xs = jax.device_put(x, sh)
    y_sh = jax.jit(lambda *a: dau_conv2d_op(cfg, *a),
                   in_shardings=(sh, None, None, None, None),
                   out_shardings=sh)(xs, w, mu1, mu2, sig)
    np.testing.assert_allclose(np.asarray(y_sh), np.asarray(y_ref),
                               rtol=2e-5, atol=2e-6)


def test_sharded_training_with_batch_stats():
    """BatchNorm models (the CIFAR net) train under the sharded step; the
    mutable batch_stats collection rides in TrainState.extra_vars."""
    from dau_convnet.models import DAUCifarNet

    model = DAUCifarNet(train=True)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((8, 3, 32, 32)), jnp.float32)
    y = jnp.asarray(rng.integers(0, 10, (8,)))
    tx = optax.sgd(1e-3)
    mesh = make_mesh(jax.devices()[:8], model=1)
    state, sh = init_sharded(model, tx, mesh, x)
    assert "batch_stats" in state.extra_vars
    step = make_train_step(model, tx, mesh, sh, donate=False)

    losses = []
    for _ in range(3):
        state, loss = step(state, x, y)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    # batch stats actually updated
    bs = state.extra_vars["batch_stats"]
    leaf = jax.tree_util.tree_leaves(bs)[0]
    assert np.any(np.asarray(leaf) != 0.0)


class FunctionalTinyNet:
    """TinyDAUNet without flax: one DAULayer + dense head in the
    `init`/`apply` form make_train_step consumes."""

    def __init__(self, engine, remat_phi=False):
        from dau_convnet.nn import DAULayer

        self.dau = DAULayer(filters=8, dau_units=(2, 1), max_kernel_size=9,
                            use_bias=False, engine=engine,
                            remat_phi=remat_phi)

    def init(self, rng, x):
        k1, k2 = jax.random.split(rng)
        return {"params": {
            "dau": self.dau.init(k1, x.shape[1]),
            "head": {"kernel": jax.nn.initializers.lecun_normal()(k2, (8, 4)),
                     "bias": jnp.zeros((4,))}}}

    def apply(self, variables, x):
        p = variables["params"]
        x = self.dau.apply(p["dau"], x, activation=jax.nn.relu)
        return x.mean(axis=(2, 3)) @ p["head"]["kernel"] + p["head"]["bias"]


def _one_step_vs_single(model, mesh, tx):
    x, y = _data()
    state, sh = init_sharded(model, tx, mesh, x, rng=jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)

    def loss_fn(p):
        logits = model.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    loss_ref, grads = jax.jit(jax.value_and_grad(loss_fn))(params0)
    updates, _ = tx.update(grads, tx.init(params0))
    params_ref = optax.apply_updates(params0, updates)

    step = make_train_step(model, tx, mesh, sh, donate=False)
    state1, loss = step(state, x, y)
    np.testing.assert_allclose(float(loss), float(loss_ref),
                               rtol=2e-5, atol=2e-6)
    for a, b in zip(jax.tree_util.tree_leaves(state1.params),
                    jax.tree_util.tree_leaves(params_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)
    return state1


@pytest.mark.parametrize("engine", ["xla", "fourier"])
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (1, 4), (8, 1)],
                         ids=["dp4", "dp2_x_tp2", "tp4", "dp8"])
def test_functional_sharded_step_matches_single_device(mesh_shape, engine):
    """The flax-free model under make_train_step on every mesh shape the
    four- and eight-device layouts allow, against the unsharded step."""
    data, model_par = mesh_shape
    mesh = make_mesh(jax.devices()[:data * model_par], data=data,
                     model=model_par)
    state1 = _one_step_vs_single(FunctionalTinyNet(engine), mesh,
                                 optax.sgd(0.1))
    w_sh = state1.params["dau"]["weights"].sharding
    expect = (None, None, None, "model") if model_par > 1 else ()
    assert tuple(w_sh.spec) == expect


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)],
                         ids=["dp4", "dp2_x_tp2"])
def test_remat_phi_under_mesh(mesh_shape):
    """remat_phi (the phase table rebuilt in the backward) under a sharded
    step gives the unsharded numbers."""
    data, model_par = mesh_shape
    mesh = make_mesh(jax.devices()[:data * model_par], data=data,
                     model=model_par)
    _one_step_vs_single(FunctionalTinyNet("fourier", remat_phi=True), mesh,
                        optax.sgd(0.1))
