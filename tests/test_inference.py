"""Serving path: `dau_conv2d_infer` + `precompute_phi` + layer phi caching.

The reference has no separate serving path (inference runs the same op,
README.md:37-39); this package adds one because the fourier engine's phase
table is a pure function of the frozen (w, mu1, mu2) - a constant at serving
time. Contract pinned here: the cached-phi forward is BIT-EXACT against the
regular op forward (same table build, same apply), across param refreshes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dau_convnet.nn import DAUConv2d, refresh_phi_cache
from dau_convnet.ops import (DAUConvSettings, dau_conv2d_infer,
                                 dau_conv2d_op, precompute_phi)


def _inputs(n=2, s=6, h=10, w=10, f=8, g=2, dtype=jnp.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.random((n, s, h, w)), dtype)
    wp = jnp.asarray(rng.standard_normal((1, s, g, f)) * 0.1, dtype)
    mu1 = jnp.asarray(rng.uniform(-3, 3, (1, s, g, f)), dtype)
    mu2 = jnp.asarray(rng.uniform(-3, 3, (1, s, g, f)), dtype)
    sigma = jnp.full((1, s, g, f), 0.5, dtype)
    return x, wp, mu1, mu2, sigma


@pytest.mark.parametrize("engine", ["fourier", "xla"])
def test_infer_matches_op_forward(engine):
    x, w, mu1, mu2, sigma = _inputs()
    cfg = DAUConvSettings(kernel_size=9, engine=engine, precision="default",
                          compute_sigma_grad=False)
    y_op = dau_conv2d_op(cfg, x, w, mu1, mu2, sigma)
    y_inf = dau_conv2d_infer(cfg, x, w, mu1, mu2, sigma)
    assert jnp.array_equal(y_op, y_inf)


def test_precomputed_phi_bit_exact():
    x, w, mu1, mu2, sigma = _inputs()
    cfg = DAUConvSettings(kernel_size=9, engine="fourier",
                          precision="default", compute_sigma_grad=False)
    phi = precompute_phi(cfg, x.shape[-2:], w, mu1, mu2)
    y_cached = dau_conv2d_infer(cfg, x, w, mu1, mu2, sigma, phi=phi)
    y_plain = dau_conv2d_op(cfg, x, w, mu1, mu2, sigma)
    assert jnp.array_equal(y_cached, y_plain)


def test_precomputed_phi_masks_dummy_units():
    # the table build must apply the dummy-unit mask exactly like the op
    x, w, mu1, mu2, sigma = _inputs(g=2)
    cfg = DAUConvSettings(kernel_size=9, engine="fourier",
                          precision="default", compute_sigma_grad=False,
                          number_units_ignore=1)
    phi = precompute_phi(cfg, x.shape[-2:], w, mu1, mu2)
    y_cached = dau_conv2d_infer(cfg, x, w, mu1, mu2, sigma, phi=phi)
    y_plain = dau_conv2d_op(cfg, x, w, mu1, mu2, sigma)
    assert jnp.array_equal(y_cached, y_plain)


def test_precompute_phi_requires_fourier():
    x, w, mu1, mu2, sigma = _inputs()
    cfg = DAUConvSettings(kernel_size=9, engine="xla", precision="default",
                          compute_sigma_grad=False)
    with pytest.raises(ValueError, match="fourier"):
        precompute_phi(cfg, x.shape[-2:], w, mu1, mu2)
    fcfg = DAUConvSettings(kernel_size=9, engine="fourier",
                           precision="default", compute_sigma_grad=False)
    phi = precompute_phi(fcfg, x.shape[-2:], w, mu1, mu2)
    with pytest.raises(ValueError, match="fourier"):
        dau_conv2d_infer(cfg, x, w, mu1, mu2, sigma, phi=phi)


def _layer_pair(**kw):
    base = dict(filters=8, dau_units=(2, 1), max_kernel_size=9,
                engine="fourier", dtype=jnp.float32, precision="default")
    base.update(kw)
    return DAUConv2d(**base), DAUConv2d(phi_caching=True, **base)


def test_layer_phi_cache_bit_exact_and_refresh():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.random((2, 6, 12, 12)), jnp.float32)
    plain, cached = _layer_pair()
    v_plain = plain.init(jax.random.PRNGKey(0), x)
    v = cached.init(jax.random.PRNGKey(0), x)
    assert "phi_cache" in v
    assert jnp.array_equal(plain.apply(v_plain, x), cached.apply(v, x))

    # params change (e.g. a checkpoint load): refresh recomputes the table
    new_params = jax.tree_util.tree_map(lambda a: a * 1.25, v["params"])
    v2 = refresh_phi_cache(cached, {"params": new_params,
                                    "phi_cache": v["phi_cache"]}, x)
    assert jnp.array_equal(plain.apply({"params": new_params}, x),
                           cached.apply(v2, x))

    # refresh also materializes the collection from scratch
    v3 = refresh_phi_cache(cached, {"params": new_params}, x)
    assert jnp.array_equal(cached.apply(v3, x), cached.apply(v2, x))


def test_layer_phi_cache_jits_without_rebuild():
    """Under jit, the cached table is a plain array argument: the compiled
    serving fn contains no phase-table build for it (smoke: it compiles and
    matches)."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.random((2, 6, 12, 12)), jnp.float32)
    plain, cached = _layer_pair()
    v = cached.init(jax.random.PRNGKey(0), x)
    serve = jax.jit(lambda vars_, xx: cached.apply(vars_, xx))
    y = serve(v, x)
    assert jnp.array_equal(y, plain.apply({"params": v["params"]}, x))


def test_layer_phi_cache_noop_for_xla_engine():
    # non-fourier engines have no table: the knob must be a silent no-op
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random((2, 6, 12, 12)), jnp.float32)
    plain, cached = _layer_pair(engine="xla")
    v = cached.init(jax.random.PRNGKey(0), x)
    assert "phi_cache" not in v
    assert jnp.array_equal(plain.apply(v, x), cached.apply(v, x))
