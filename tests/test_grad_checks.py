"""Gradient and compilation-behavior checks beyond the reference suite
(SURVEY.md section 4.5: finite-difference checks + jit-compile-once)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.test_util import check_grads

from dau_convnet.ops import DAUConvSettings, dau_conv2d_op

from helpers import random_case


def _case(seed=0):
    rng = np.random.default_rng(seed)
    x, w, mu1, mu2, sigma, err = random_case(
        rng, N=1, W=8, H=7, S=2, F=3, units=(2, 1), max_kernel_size=9,
        max_offset_init=2)
    cfg = DAUConvSettings(kernel_size=9)
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1), w.shape).astype(np.float32)
    return cfg, x, w, mu1, mu2, sig


def test_finite_difference_w():
    """The op is linear in w and the w-gradient is the true adjoint, so it
    must match finite differences exactly."""
    cfg, x, w, mu1, mu2, sig = _case()
    check_grads(lambda w: dau_conv2d_op(cfg, x, w, mu1, mu2, sig),
                (jnp.asarray(w),), order=1, modes=("rev",),
                atol=1e-2, rtol=1e-2)


def test_input_grad_is_reference_not_true_adjoint():
    """The reference's input gradient blurs-then-shifts the error (the same
    order as the forward, base_dau_conv_layer.cu:294-325) rather than the
    true adjoint shift-then-blur; the two differ near image borders where
    the blurred intermediate is cropped. Pin both facts: close to the true
    derivative overall, not exactly equal on a border-dominated image."""
    cfg, x, w, mu1, mu2, sig = _case()

    def f(x):
        return jnp.sum(dau_conv2d_op(cfg, x, w, mu1, mu2, sig) ** 2)

    g = jax.grad(f)(jnp.asarray(x))
    d = jax.random.normal(jax.random.PRNGKey(0), x.shape)
    eps = 1e-3
    fd = float((f(jnp.asarray(x) + eps * d) - f(jnp.asarray(x) - eps * d))
               / (2 * eps))
    vjp_dir = float(jnp.vdot(g, d))
    rel = abs(fd - vjp_dir) / max(abs(fd), 1e-9)
    assert rel < 0.15, f"input grad too far from derivative: rel {rel}"


def test_mu_grad_is_analytic_not_autodiff():
    """mu gradients follow the analytic Gaussian-derivative semantics of the
    reference, which differ from autodiff of the bilinear forward (the
    4-tap interpolation has piecewise-linear autodiff derivatives). This
    pins that we intentionally do NOT match finite differences in mu."""
    cfg, x, w, mu1, mu2, sig = _case(1)

    def f(mu1):
        return jnp.sum(dau_conv2d_op(cfg, x, w, mu1, mu2, sig))

    g_custom = jax.grad(f)(jnp.asarray(mu1))
    # numeric derivative of the *bilinear* forward
    eps = 1e-3
    up = f(jnp.asarray(mu1) + eps)
    dn = f(jnp.asarray(mu1) - eps)
    fd_total = float((up - dn) / (2 * eps))
    # the two are correlated (both approximate dG/dmu) but not equal
    total_custom = float(jnp.sum(g_custom))
    assert np.isfinite(total_custom) and np.isfinite(fd_total)
    # same sign and same order of magnitude (loose analytic-vs-bilinear bound)
    if abs(fd_total) > 1e-3:
        assert np.sign(total_custom) == np.sign(fd_total)
        assert 0.2 < abs(total_custom / fd_total) < 5.0


def test_jit_compile_once():
    """Repeated calls with the same shapes must not retrace/recompile."""
    cfg, x, w, mu1, mu2, sig = _case(2)
    traces = 0

    @jax.jit
    def f(x, w, mu1, mu2, sig):
        nonlocal traces
        traces += 1
        return dau_conv2d_op(cfg, x, w, mu1, mu2, sig)

    for i in range(3):
        y = f(jnp.asarray(x) + i, jnp.asarray(w), jnp.asarray(mu1),
              jnp.asarray(mu2), jnp.asarray(sig))
    jax.block_until_ready(y)
    assert traces == 1


def test_vmap_and_grad_compose():
    """The custom_vjp composes with vmap (e.g. per-example grads)."""
    cfg, x, w, mu1, mu2, sig = _case(3)

    def per_example_loss(xi):
        return jnp.sum(dau_conv2d_op(cfg, xi[None], w, mu1, mu2, sig) ** 2)

    grads = jax.vmap(jax.grad(per_example_loss))(jnp.asarray(x))
    assert grads.shape == x.shape
    assert np.all(np.isfinite(np.asarray(grads)))


def test_nan_guard_mu_grads():
    """The reference unconditionally converts NaN mu1/mu2 grads to 0 as the
    final step of Backward_gpu (base_dau_conv_layer.cu:354-356) while w
    grads pass through raw. Inject an inf into the error with one unit's
    w = 0: the chain-rule multiply grads*w produces inf*0 = NaN in the mu
    grads, which the guard must zero; the w grad keeps the non-finite
    poison (matching the reference, which only guards mu)."""
    cfg, x, w, mu1, mu2, sig = _case(4)
    w = np.array(w)
    w[0, 0, 0, 0] = 0.0  # inf * 0 -> NaN in dmu = grads * w

    def loss(w, mu1, mu2, cfg=cfg):
        y = dau_conv2d_op(cfg, x, jnp.asarray(w), mu1, mu2, sig)
        err = jnp.zeros_like(y).at[0, 0, 3, 3].set(jnp.inf)
        return jnp.vdot(y, err)

    dw, dmu1, dmu2 = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(mu1), jnp.asarray(mu2))
    assert not np.all(np.isfinite(np.asarray(dw))), "w grad must propagate"
    assert np.all(np.isfinite(np.asarray(dmu1)))
    assert np.all(np.isfinite(np.asarray(dmu2)))

    # with the guard off the NaN reaches the mu grads (documents the flag)
    cfg_off = DAUConvSettings(kernel_size=9, nan_guard_mu_grads=False)
    dmu1_raw = jax.grad(lambda w, m1, m2: loss(w, m1, m2, cfg_off),
                        argnums=1)(jnp.asarray(w), jnp.asarray(mu1),
                                   jnp.asarray(mu2))
    assert np.any(np.isnan(np.asarray(dmu1_raw)))
