"""Round-2 parity features: manual variable loading, static kernel tiers at
the layer level, and the trainable-sigma contract.

Reference behaviors covered:
- `set_dau_variables_manually` (plugins/tensorflow/dau_conv/dau_conv.py:344-359)
- runtime kernel-tier dispatch (dau_conv_op.cpp:223-256) as a static layer
  promise (`static_max_offset`)
- the sigma bounds guard (base_dau_conv_layer.cu:33-49) + dynamic blur-filter
  sizing (base_dau_conv_layer.cpp:146-158) as an op-level clip to the static
  filter's support.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from dau_convnet.nn import DAUConv2d, set_dau_variables_manually
from dau_convnet.ops import DAUConvSettings, dau_conv2d_op
from dau_convnet.ops import reference as oracle

from helpers import assert_matrix


def _layer_and_input(max_kernel_size=9, S=3, F=4, units=(2, 1), HW=12,
                     **kwargs):
    layer = DAUConv2d(filters=F, dau_units=units,
                      max_kernel_size=max_kernel_size, use_bias=False,
                      **kwargs)
    x = np.random.default_rng(0).random((2, S, HW, HW)).astype(np.float32)
    return layer, jnp.asarray(x)


def test_set_dau_variables_manually_matches_oracle():
    layer, x = _layer_and_input()
    variables = layer.init(jax.random.PRNGKey(0), x)

    rng = np.random.default_rng(1)
    S, F, G = 3, 4, 2
    w = (rng.standard_normal((1, S, G, F)) * 0.1).astype(np.float32)
    mu1 = rng.uniform(-3, 3, (1, S, G, F)).astype(np.float32)
    mu2 = rng.uniform(-3, 3, (1, S, G, F)).astype(np.float32)

    patched = set_dau_variables_manually(
        variables, "", weights=w, mu1=mu1, mu2=mu2, sigma=0.5)
    # scalar sigma is reshaped to the stored (1,) parameter
    assert patched["params"]["sigma"].shape == (1,)
    np.testing.assert_array_equal(
        np.asarray(patched["params"]["weights"]), w)

    y = jax.jit(layer.apply)(patched, x)
    gt = oracle.forward(np.asarray(x), w, mu1, mu2, [0.5])
    assert_matrix(np.asarray(y), gt, "manual_params_fwd")


def test_set_dau_variables_manually_validates():
    layer, x = _layer_and_input()
    variables = layer.init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="shape"):
        set_dau_variables_manually(variables, "",
                                   weights=np.zeros((1, 3, 2, 5), np.float32))
    with pytest.raises(KeyError, match="not found"):
        set_dau_variables_manually(variables, "nope", sigma=0.5)
    # original pytree is untouched
    patched = set_dau_variables_manually(variables, "", sigma=0.7)
    assert float(variables["params"]["sigma"][0]) == pytest.approx(0.5)
    assert float(patched["params"]["sigma"][0]) == pytest.approx(0.7)


def test_static_max_offset_uses_small_tier_and_matches_oracle():
    """A k=17 layer whose offsets are promised <= 3 must compute with the
    k=9-tier synthesized kernel (the reference's dynamic-kernel-size
    optimization, dau_conv_op.cpp:242-256) and still match the oracle."""
    cfg = DAUConvSettings(kernel_size=17, static_max_offset=3.0)
    assert cfg.synth_kernel_size == 9  # not 19

    layer, x = _layer_and_input(max_kernel_size=17, static_max_offset=3.0,
                                HW=16)
    variables = layer.init(jax.random.PRNGKey(0), x)

    rng = np.random.default_rng(2)
    S, F, G = 3, 4, 2
    w = (rng.standard_normal((1, S, G, F)) * 0.1).astype(np.float32)
    mu1 = rng.uniform(-3, 3, (1, S, G, F)).astype(np.float32)
    mu2 = rng.uniform(-3, 3, (1, S, G, F)).astype(np.float32)
    variables = set_dau_variables_manually(
        variables, "", weights=w, mu1=mu1, mu2=mu2)

    # the lowered computation must not contain the full 19x19 synth kernel
    hlo = jax.jit(layer.apply).lower(variables, x).as_text()
    assert "19,19" not in hlo and "19x19" not in hlo

    y = jax.jit(layer.apply)(variables, x)
    gt = oracle.forward(np.asarray(x), w, mu1, mu2, [0.5])
    assert_matrix(np.asarray(y), gt, "tiered_fwd")


def test_static_max_offset_clips_mu():
    """Offsets beyond the promised bound are clipped (the safe contract; the
    reference would instead re-dispatch to a larger tier at runtime)."""
    layer, x = _layer_and_input(static_max_offset=2.0)
    variables = layer.init(jax.random.PRNGKey(0), x)
    S, F, G = 3, 4, 2
    w = np.full((1, S, G, F), 0.1, np.float32)
    mu_big = np.full((1, S, G, F), 3.5, np.float32)
    variables = set_dau_variables_manually(
        variables, "", weights=w, mu1=mu_big, mu2=mu_big)
    y = jax.jit(layer.apply)(variables, x)
    gt = oracle.forward(np.asarray(x), w, np.full_like(mu_big, 2.0),
                        np.full_like(mu_big, 2.0), [0.5])
    assert_matrix(np.asarray(y), gt, "clipped_mu_fwd")


def test_sigma_clipped_to_bounds_in_op():
    """Reference bounds guard (base_dau_conv_layer.cu:33-49): sigma below
    sigma_lower_bound computes as the bound; sigma beyond the static blur
    filter's support clips to the support bound (no silent truncation)."""
    rng = np.random.default_rng(3)
    S, F, G = 3, 4, 2
    x = jnp.asarray(rng.random((1, S, 10, 10)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((1, S, G, F)) * 0.1, jnp.float32)
    mu1 = jnp.asarray(rng.uniform(-3, 3, (1, S, G, F)), jnp.float32)
    mu2 = jnp.asarray(rng.uniform(-3, 3, (1, S, G, F)), jnp.float32)
    cfg = DAUConvSettings(kernel_size=9)
    assert cfg.sigma_upper_bound == pytest.approx(0.8)

    def run(sig):
        return jax.jit(lambda *a: dau_conv2d_op(cfg, *a))(
            x, w, mu1, mu2, jnp.full((1,), sig, jnp.float32))

    np.testing.assert_allclose(np.asarray(run(0.05)), np.asarray(run(0.3)),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(run(5.0)), np.asarray(run(0.8)),
                               rtol=1e-6)

    with pytest.raises(ValueError, match="sigma_lower_bound"):
        DAUConvSettings(kernel_size=9, sigma_lower_bound=1.0, blur_size=9)


def test_trainable_sigma_training_matches_oracle():
    """dau_sigma_trainable=True: sigma moves during training, the blur filter
    is sized for growth (17x17, the reference's own hard cap), and the final
    output still matches the oracle at the final sigma."""
    layer, x = _layer_and_input(dau_sigma_trainable=True, HW=10)
    variables = layer.init(jax.random.PRNGKey(0), x)
    sigma0 = float(variables["params"]["sigma"][0])

    target = jnp.ones((2, 4, 10, 10), jnp.float32)
    tx = optax.adam(5e-2)

    @jax.jit
    def train(variables):
        opt = tx.init(variables)

        def step(carry, _):
            v, o = carry
            loss, g = jax.value_and_grad(
                lambda v: jnp.mean((layer.apply(v, x) - target) ** 2))(v)
            u, o = tx.update(g, o)
            return (optax.apply_updates(v, u), o), loss

        (v, _), losses = jax.lax.scan(step, (variables, opt), None, length=10)
        return v, losses

    v1, losses = train(variables)
    sigma1 = float(v1["params"]["sigma"][0])
    assert abs(sigma1 - sigma0) > 1e-3, "sigma did not move"
    assert float(losses[-1]) < float(losses[0])

    # final output matches the oracle at the final (clipped) sigma, on the
    # trainable-sigma blur grid
    p = v1["params"]
    sig_eff = float(np.clip(sigma1, 0.3, 1.6))
    bound = 4 - 0.01
    gt = oracle.forward(
        np.asarray(x), np.asarray(p["weights"]),
        np.clip(np.asarray(p["mu1"]), -bound, bound),
        np.clip(np.asarray(p["mu2"]), -bound, bound),
        [sig_eff], blur_size=17)
    y = jax.jit(layer.apply)(v1, x)
    assert_matrix(np.asarray(y), gt, "trainable_sigma_fwd")


def test_engine_auto_resolution():
    """'auto' resolves at construction: fourier for production bf16
    precision, xla for the f32 oracle mode (round-2 verdict: the documented
    quick start must get the measured-fastest engine)."""
    from dau_convnet.ops import DAUConvSettings

    assert DAUConvSettings(precision="default").engine == "fourier"
    assert DAUConvSettings(precision="highest").engine == "xla"
    # explicit choice is never overridden
    assert DAUConvSettings(engine="fourier", precision="highest").engine == "fourier"
    with pytest.raises(ValueError, match="unknown engine"):
        DAUConvSettings(engine="spectral")


def test_remat_phi_matches_default():
    """remat_phi=True rebuilds the fourier phase table in the backward
    instead of stashing it as a residual; numerics must be unchanged
    (the rebuild runs the identical computation on the same inputs)."""
    import dataclasses

    rng = np.random.default_rng(3)
    N, S, G, F, H, W = 2, 4, 2, 4, 10, 9
    x = jnp.asarray(rng.random((N, S, H, W)), jnp.float32)
    err = jnp.asarray(rng.standard_normal((N, F, H, W)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((1, S, G, F)) * 0.1, jnp.float32)
    mu1 = jnp.asarray(rng.uniform(-3, 3, (1, S, G, F)), jnp.float32)
    mu2 = jnp.asarray(rng.uniform(-3, 3, (1, S, G, F)), jnp.float32)
    sig = jnp.full((1, S, G, F), 0.5, jnp.float32)
    cfg0 = DAUConvSettings(kernel_size=9, engine="fourier")
    cfg1 = dataclasses.replace(cfg0, remat_phi=True)

    def run(cfg):
        @jax.jit
        def f(x, w, mu1, mu2, sig, err):
            y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a),
                             x, w, mu1, mu2, sig)
            return y, vjp(err)
        return f(x, w, mu1, mu2, sig, err)

    y0, g0 = run(cfg0)
    y1, g1 = run(cfg1)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y0), rtol=1e-6)
    for a, b, nm in zip(g1, g0, ["dx", "dw", "dmu1", "dmu2", "dsig"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7, err_msg=nm)


def test_jax_checkpoint_composes():
    """`jax.checkpoint` around a two-DAU-layer function (the standard
    activation-memory lever for deep stacks) must leave gradients exactly
    equal to the unremated form - the custom-VJP op's residuals ride
    through remat - for both engines."""
    import dataclasses

    rng = np.random.default_rng(7)
    N, S, G, F, H, W = 2, 8, 2, 8, 10, 9
    x = jnp.asarray(rng.random((N, S, H, W)), jnp.float32)
    err = jnp.asarray(rng.standard_normal((N, F, H, W)), jnp.float32)
    w1 = jnp.asarray(rng.standard_normal((1, S, G, F)) * 0.1, jnp.float32)
    w2 = jnp.asarray(rng.standard_normal((1, F, G, F)) * 0.1, jnp.float32)
    mu = jnp.asarray(rng.uniform(-3, 3, (1, S, G, F)), jnp.float32)
    mu2l = jnp.asarray(rng.uniform(-3, 3, (1, F, G, F)), jnp.float32)
    sig1 = jnp.full((1, S, G, F), 0.5, jnp.float32)
    sig2 = jnp.full((1, F, G, F), 0.5, jnp.float32)

    for engine in ("xla", "fourier"):
        cfg = DAUConvSettings(kernel_size=9, engine=engine)

        def stack(x, w1, w2):
            h = jax.nn.relu(dau_conv2d_op(cfg, x, w1, mu, mu, sig1))
            return dau_conv2d_op(cfg, h, w2, mu2l, mu2l, sig2)

        def run(f):
            @jax.jit
            def g(x, w1, w2, err):
                y, vjp = jax.vjp(f, x, w1, w2)
                return y, vjp(err)
            return g(x, w1, w2, err)

        y0, g0 = run(stack)
        y1, g1 = run(jax.checkpoint(stack))
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y0),
                                   rtol=1e-6, err_msg=f"engine={engine}")
        for a, b, nm in zip(g1, g0, ["dx", "dw1", "dw2"]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{nm} engine={engine}")


@pytest.mark.parametrize("field", ["fused_bwd", "fused_dx", "fused_gather",
                                   "data_axis", "model_axis"])
def test_removed_settings_raise(field):
    """The fused-backward kernel and its routing settings are gone: the
    plain XLA path is the only one, so no setting selects another."""
    with pytest.raises(TypeError, match=field):
        DAUConvSettings(**{field: "on"})


@pytest.mark.parametrize("engine", ["pallas", "pallas_fused"])
def test_removed_engines_raise(engine):
    with pytest.raises(ValueError, match="unknown engine"):
        DAUConvSettings(engine=engine)
