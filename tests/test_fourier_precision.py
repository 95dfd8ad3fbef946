"""Production-precision guard for the Fourier engine.

The model benchmark runs engine='fourier' in bf16 (DEFAULT precision). These
tests pin that the fourier path's bf16 error against the f32 oracle is in
the same class as the spatial engine's bf16 error - i.e. switching engines
does not degrade production numerics (the f32/HIGHEST exactness is covered
by the oracle matrix in test_op_vs_oracle.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dau_convnet.ops import DAUConvSettings, dau_conv2d_op


def _rel_err(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max() + 1e-12
    return np.abs(a - ref).max() / scale


def _run(engine, dtype, x, w, mu1, mu2, sigma, err):
    cfg = DAUConvSettings(
        kernel_size=9, compute_sigma_grad=False,
        precision="highest" if dtype == jnp.float32 else "default",
        engine=engine)
    args = [jnp.asarray(a, dtype) for a in (x, w, mu1, mu2)]
    sig = jnp.asarray(sigma, dtype)

    @jax.jit
    def fwd_bwd(x, w, mu1, mu2):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a, sig), *args)
        return y, vjp(jnp.asarray(err, dtype))

    y, (dx, dw, dmu1, dmu2) = fwd_bwd(*args)
    return [np.asarray(v, np.float64) for v in (y, dx, dw, dmu1, dmu2)]


@pytest.mark.parametrize("seed", [0, 1])
def test_fourier_bf16_error_class_matches_spatial(seed):
    rng = np.random.default_rng(seed)
    N, S, G, F, HW = 2, 16, 2, 16, 14
    x = rng.random((N, S, HW, HW)).astype(np.float32)
    w = (rng.standard_normal((1, S, G, F)) * 0.1).astype(np.float32)
    mu1 = rng.uniform(-3.9, 3.9, (1, S, G, F)).astype(np.float32)
    mu2 = rng.uniform(-3.9, 3.9, (1, S, G, F)).astype(np.float32)
    sigma = np.full((1,), 0.5, np.float32)
    err = rng.standard_normal((N, F, HW, HW)).astype(np.float32)

    ref = _run("xla", jnp.float32, x, w, mu1, mu2, sigma, err)
    sp16 = _run("xla", jnp.bfloat16, x, w, mu1, mu2, sigma, err)
    fo16 = _run("fourier", jnp.bfloat16, x, w, mu1, mu2, sigma, err)

    names = ("fwd", "dx", "dw", "dmu1", "dmu2")
    for name, r, a, b in zip(names, ref, sp16, fo16):
        e_sp = _rel_err(a, r)
        e_fo = _rel_err(b, r)
        # same error class: within 4x of the spatial engine's bf16 error
        # (and sane in absolute terms)
        assert e_fo < max(4.0 * e_sp, 1e-3), (
            f"{name}: fourier bf16 rel err {e_fo:.2e} vs spatial {e_sp:.2e}")
        assert e_fo < 0.1, f"{name}: fourier bf16 rel err {e_fo:.2e} too large"


def test_phase_tables_match_trig_f32():
    """_tap_phase_tables (integer cos/sin lookup via skinny matmul) must
    reproduce _tap_phase (runtime transcendentals) to f32 roundoff for
    in-contract mu (|mu| <= span - 1)."""
    from dau_convnet.ops import fourier_engine as fe

    rng = np.random.default_rng(3)
    mu = jnp.asarray(rng.uniform(-3.99, 3.99, (8, 2, 16)), jnp.float32)
    for p, nbins in ((17, 17), (17, 9)):
        for interp in (True, False):
            re_t, im_t = fe._tap_phase(mu, p, nbins, interp, jnp.float32,
                                       bin_leading=True)
            re_l, im_l = fe._tap_phase_tables(
                mu, p, nbins, interp, jnp.float32, span=5,
                precision=jax.lax.Precision.HIGHEST)
            np.testing.assert_allclose(np.asarray(re_l), np.asarray(re_t),
                                       atol=2e-5)
            np.testing.assert_allclose(np.asarray(im_l), np.asarray(im_t),
                                       atol=2e-5)


def test_build_phi_tables_match_trig_f32():
    from dau_convnet.ops import fourier_engine as fe

    rng = np.random.default_rng(4)
    S, G, F = 6, 2, 8
    w = jnp.asarray(rng.standard_normal((S, G, F)) * 0.1, jnp.float32)
    mu1 = jnp.asarray(rng.uniform(-3.9, 3.9, (S, G, F)), jnp.float32)
    mu2 = jnp.asarray(rng.uniform(-3.9, 3.9, (S, G, F)), jnp.float32)
    p1, p2, rb = fe.plan_bins(13, 13, 9)
    a = jnp.stack(fe.build_phi(w, mu1, mu2, p1, p2, rb))
    b = jnp.stack(fe.build_phi(w, mu1, mu2, p1, p2, rb, phase_span=5,
                               precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=3e-6)


@pytest.mark.parametrize("engine", ["xla", "fourier"])
@pytest.mark.parametrize("shape", [(2, 16, 12, 9), (3, 8, 20, 13)],
                         ids=["s16f12", "s8f20"])
def test_f64_matches_oracle_to_f64_roundoff(engine, shape):
    """float64 operands compute in float64 in both engines (the fourier
    engine's angles, accumulations and spectra follow the operands), so
    the op agrees with the float64 oracle to ~1e-15."""
    from dau_convnet.ops import reference

    n, s, f, hw = shape
    rng = np.random.default_rng(5)
    x = rng.random((n, s, hw, hw))
    w = rng.standard_normal((1, s, 2, f)) * 0.1
    mu1, mu2 = rng.uniform(-3.9, 3.9, (2, 1, s, 2, f))
    err = rng.standard_normal((n, f, hw, hw))
    with jax.enable_x64(True):
        cfg = DAUConvSettings(kernel_size=9, compute_sigma_grad=False,
                              precision="highest", engine=engine)
        sig = jnp.full((1,), 0.5, jnp.float64)
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a, sig),
                         *(jnp.asarray(a, jnp.float64)
                           for a in (x, w, mu1, mu2)))
        got = [y, *vjp(jnp.asarray(err, jnp.float64))]
        assert all(g.dtype == jnp.float64 for g in got)
    want = [reference.forward(x, w, mu1, mu2, [0.5])]
    want.append(reference.forward(
        err, np.swapaxes(w, 1, 3), np.swapaxes(-mu1, 1, 3),
        np.swapaxes(-mu2, 1, 3), [0.5], do_error_backprop=True))
    want.extend(reference.backward(x, err, w, mu1, mu2, [0.5])[1:4])
    for name, g, r in zip(("y", "dx", "dw", "dmu1", "dmu2"), got, want):
        assert _rel_err(g, r) < 1e-12, (name, _rel_err(g, r))
