"""Shared-displacement DAU variant vs the standard op with broadcast mu."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dau_convnet.ops import DAUConvSettings, dau_conv2d_op
from dau_convnet.ops.shared_engine import dau_conv2d_shared_op


def _case(seed=0, N=2, S=3, G=2, F=4, H=9, W=11):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.random((N, S, H, W)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((S, G, F)) * 0.1, jnp.float32)
    mu1 = jnp.asarray(rng.uniform(-3, 3, (S, G)), jnp.float32)
    mu2 = jnp.asarray(rng.uniform(-3, 3, (S, G)), jnp.float32)
    sig = jnp.asarray([0.5], jnp.float32)
    err = jnp.asarray(rng.standard_normal((N, F, H, W)), jnp.float32)
    return x, w, mu1, mu2, sig, err


@pytest.mark.parametrize("engine", ["xla", "fourier"])
def test_shared_forward_equals_broadcast_standard(engine):
    x, w, mu1, mu2, sig, _ = _case()
    cfg = DAUConvSettings(kernel_size=9, engine=engine)
    y_shared = jax.jit(lambda *a: dau_conv2d_shared_op(cfg, *a))(
        x, w, mu1, mu2, sig)
    mu1b = jnp.broadcast_to(mu1[:, :, None], w.shape)
    mu2b = jnp.broadcast_to(mu2[:, :, None], w.shape)
    y_std = jax.jit(lambda *a: dau_conv2d_op(cfg, *a))(x, w, mu1b, mu2b, sig)
    np.testing.assert_allclose(np.asarray(y_shared), np.asarray(y_std),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("engine", ["xla", "fourier"])
def test_shared_gradients_equal_broadcast_standard(engine):
    x, w, mu1, mu2, sig, err = _case(1)
    cfg = DAUConvSettings(kernel_size=9, unit_testing=True, engine=engine)

    @jax.jit
    def run_shared(x, w, mu1, mu2, sig):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_shared_op(cfg, *a),
                         x, w, mu1, mu2, sig)
        return vjp(err)

    @jax.jit
    def run_std(x, w, mu1b, mu2b, sig):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a),
                         x, w, mu1b, mu2b, sig)
        return vjp(err)

    dx_s, dw_s, dmu1_s, dmu2_s, dsig_s = run_shared(x, w, mu1, mu2, sig)
    mu1b = jnp.broadcast_to(mu1[:, :, None], w.shape)
    mu2b = jnp.broadcast_to(mu2[:, :, None], w.shape)
    dx, dw, dmu1, dmu2, dsig = run_std(x, w, mu1b, mu2b, sig)

    np.testing.assert_allclose(np.asarray(dx_s), np.asarray(dx),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(dw_s), np.asarray(dw),
                               rtol=2e-4, atol=2e-5)
    # shared-mu adjoint = per-f grads summed over f
    np.testing.assert_allclose(np.asarray(dmu1_s), np.asarray(dmu1).sum(-1),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(dmu2_s), np.asarray(dmu2).sum(-1),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(dsig_s[0]), float(np.asarray(dsig).sum()),
                               rtol=2e-3)


def test_shared_trains():
    import optax
    x, w, mu1, mu2, sig, err = _case(2)
    cfg = DAUConvSettings(kernel_size=9, compute_sigma_grad=False)

    @jax.jit
    def loss_fn(params, x):
        y = dau_conv2d_shared_op(cfg, x, *params, sig)
        return jnp.mean((y - 1.0) ** 2)

    params = (w, mu1, mu2)
    tx = optax.adam(1e-2)
    opt = tx.init(params)
    losses = []
    for _ in range(10):
        loss, g = jax.value_and_grad(loss_fn)(params, x)
        upd, opt = tx.update(g, opt)
        params = optax.apply_updates(params, upd)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
