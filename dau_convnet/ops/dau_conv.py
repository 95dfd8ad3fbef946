"""The DAU convolution primitive: `dau_conv2d_op` with a custom VJP.

JAX equivalent of the reference's layer orchestration + TF ops:

- `BaseDAUConvLayer::Forward_gpu/Backward_gpu`
  (reference src/dau_conv/base_dau_conv_layer.cu:15-363),
- the `DAUConv` / `DAUConvGrad` TensorFlow ops
  (plugins/tensorflow/src/dau_conv_op.cpp:150-320,
  plugins/tensorflow/src/dau_conv_grad_op.cpp:115-305).

What vanished by design under XLA's compilation model:
- workspace carving / 4 CUDA streams / events (base_dau_conv_layer.cpp:
  302-391, .cu:65-127): XLA owns buffers and scheduling.
- the runtime `amax(mu)` device->host sync that picks a CUDA kernel tier
  (dau_conv_op.cpp:223-256): under jit shapes are static, so the tap bound
  comes from the static `max_kernel_size` (see xla_engine docstring); use
  `utils.tiers.snap_kernel_tier` to pick a smaller static tier when offsets
  are known to be bounded.
- 11 + 17 manually instantiated CUDA kernels: jit specialization.

The backward rule reproduces the reference's *analytic* parameter gradients
(Gaussian-derivative filters), NOT autodiff of the bilinear forward - the
two differ for mu/sigma, and the reference semantics (== its numpy oracle)
are the contract. w-grad and input-grad coincide with true autodiff since
the forward is linear in both.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp
from functools import partial

import jax
import jax.numpy as jnp

from . import fourier_engine, xla_engine
from ._edge import disabled_edges
from ..utils import math as dmath
from .gaussian import (depthwise_blur, gaussian_factor_filters,
                       gaussian_filters, rank1_blur, rank1_blur_stack)

__all__ = ["DAUConvSettings", "dau_conv2d_op", "edge_gradient_mask",
           "precompute_phi", "dau_conv2d_infer"]


@dataclasses.dataclass(frozen=True)
class DAUConvSettings:
    """Static configuration of a DAU convolution.

    Mirrors the reference `DAUConvSettings` struct
    (include/dau_conv/base_dau_conv_layer.hpp:109-130) and the TF op attrs
    (dau_conv_op.cpp:22-48); names kept for API fidelity. Fields that are
    dead in the reference (`merge_iteration_step`, `merge_threshold`:
    `merge_components()` is commented out, base_dau_conv_layer.cu:28-30) are
    accepted as documented no-ops.
    """

    kernel_size: int = 9                 # static max kernel size (tap bound)
    use_interpolation: bool = True       # bilinear (4-tap) sub-pixel shift
    number_units_ignore: int = 0         # trailing dummy units (group-of-2 pad)
    single_dim_kernel: bool = False      # 1D DAU: blur only along x
    forbid_positive_dim1: bool = False   # zero blur taps at x > 0 (1D causal)
    mu_learning_rate_factor: float = 1.0 # extra factor on mu1/mu2 grads
    # NaN -> 0 on the final mu1/mu2 gradients (the reference applies this
    # unconditionally as the last step of Backward_gpu,
    # base_dau_conv_layer.cu:354-356): a diverged w (0*inf in the
    # grads*w chain-rule multiply) self-heals in mu instead of poisoning
    # the positions. w/sigma/input grads are NOT guarded, matching the
    # reference. Off = raw analytic grads (useful for debugging NaN
    # sources).
    nan_guard_mu_grads: bool = True
    unit_normalization: bool = True      # blur filter sums to 1
    square_unit_normalization: bool = False
    component_border_bound: float = 0.01 # mu clip margin from kernel edge
    sigma_lower_bound: float = 0.3
    unit_testing: bool = False           # ignore_edge_gradients GPU-compat shim
    blur_size: int = 9                   # static blur-filter size (from sigma)
    compute_sigma_grad: bool = True
    # 'xla': dense synthesized-kernel convs (spatial); 'fourier': per-bin
    # spectral contractions (same semantics, ~ks^2/(4G) fewer FLOPs - see
    # fourier_engine.py); 'auto' (default): fourier for precision='default'
    # (the production bf16 path), xla for precision='highest' (the f32
    # oracle mode). Resolved at construction. Which engine is faster on the
    # GPU at each precision has not been measured yet.
    engine: str = "auto"
    # 'highest' = true-f32 matmuls and convs (oracle-exact; no TF32 on the
    # GPU; required for the differential tests); 'default' = the backend's
    # native low-precision passes (production speed; ~1e-2 relative error on
    # f32 inputs, exact-enough for bf16).
    precision: str = "highest"
    # Static promise that |mu| <= static_max_offset, shrinking the synthesized
    # aggregation kernel. This is the trace-time replacement for the
    # reference's *runtime* kernel-tier dispatch (it reads amax(mu) from the
    # device each step and re-picks the CUDA kernel, dau_conv_op.cpp:223-256;
    # under jit shapes must be static). None = derive from kernel_size.
    static_max_offset: tp.Optional[float] = None
    # Rematerialize the fourier engine's phase table in the backward
    # instead of stashing it as a VJP residual: saves 2*B*S*F bytes of
    # device memory per layer activation set (~45 MB at AlexNet conv4 bf16)
    # for one extra phi build in the backward. Off by default; turn on for
    # large-batch / deep configs where activation memory is the limit -
    # the DAU analogue of jax.checkpoint on the layer.
    remat_phi: bool = False
    # accepted-for-parity no-ops (dead in the reference):
    merge_iteration_step: int = 0
    merge_threshold: float = 1.0
    mean_iteration_step: int = 0
    sigma_iteration_step: int = 0

    def __post_init__(self):
        if self.kernel_size % 2 != 1 or self.kernel_size < 1:
            raise ValueError(f"kernel_size must be odd and >= 1, got {self.kernel_size}")
        if self.engine not in ("auto", "xla", "fourier"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.precision not in ("highest", "default"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.engine == "auto":
            object.__setattr__(
                self, "engine",
                "fourier" if self.precision == "default" else "xla")
        if self.sigma_lower_bound > self.sigma_upper_bound:
            raise ValueError(
                f"sigma_lower_bound {self.sigma_lower_bound} exceeds the "
                f"largest sigma the static blur_size={self.blur_size} filter "
                f"supports ({self.sigma_upper_bound}); increase blur_size "
                "(reference re-sizes the filter dynamically, "
                "base_dau_conv_layer.cpp:146-158 - under jit it is static)")

    @property
    def max_offset(self) -> float:
        """Largest representable |mu| (the layer clips to this)."""
        bound = self.kernel_size // 2 - self.component_border_bound
        if self.static_max_offset is not None:
            bound = min(bound, self.static_max_offset)
        return bound

    @property
    def lax_precision(self):
        return (jax.lax.Precision.HIGHEST if self.precision == "highest"
                else jax.lax.Precision.DEFAULT)

    @property
    def synth_kernel_size(self) -> int:
        """Size of the synthesized aggregation kernel: bilinear taps reach
        floor(max_offset) + 1 in each direction."""
        return 2 * (int(math.floor(self.max_offset)) + 1) + 1

    @property
    def sigma_upper_bound(self) -> float:
        """Largest sigma the static blur filter supports without truncation.

        Inverse of the reference's dynamic filter sizing
        2*ceil(5*sigma)+1 <= blur_size (base_dau_conv_layer.cpp:146-147):
        the op clips sigma into [sigma_lower_bound, sigma_upper_bound], so a
        trainable sigma can never silently truncate against the static
        filter support."""
        return (self.blur_size - 1) / 10.0


def edge_gradient_mask(h: int, w: int, dtype=jnp.float32):
    """Static (h, w) mask zeroing the last row/col per the reference's GPU
    tile rule - only used under `unit_testing` for CUDA-compat differential
    tests (dau_conv_test.py:107-136, dau_conv_backward_core.hpp:2477-2560).
    """
    zero_row, zero_col = disabled_edges(h, w)
    mask = jnp.ones((h, w), dtype=dtype)
    if zero_col:
        mask = mask.at[:, w - 1].set(0.0)
    if zero_row:
        mask = mask.at[h - 1, :].set(0.0)
    return mask


def _unit_mask(s: int, g: int, f: int, num_ignore: int, dtype):
    """(S, G, F) mask that zeroes the trailing `num_ignore` dummy units
    (reference `set_last_n_gauss_to_zero`, base_dau_conv_layer.cu:365-381)."""
    if num_ignore == 0:
        return None
    gmask = (jnp.arange(g) < g - num_ignore).astype(dtype)
    return jnp.broadcast_to(gmask[None, :, None], (s, g, f))


def _squeeze_params(w, mu1, mu2):
    """Accept reference [1, S, G, F] or bare [S, G, F] parameter layout."""
    if w.ndim == 4:
        if w.shape[0] != 1:
            raise ValueError(f"expected leading param dim 1, got {w.shape}")
        return w[0], mu1[0], mu2[0], True
    return w, mu1, mu2, False


def _sigma_scalar(cfg: DAUConvSettings, sigma):
    """The layer-shared blur sigma: first element of the (tiled) sigma tensor
    (the reference shares one sigma across the layer; dau_conv.py:417-430),
    clipped into [sigma_lower_bound, sigma_upper_bound] - the reference's
    bounds guard (base_dau_conv_layer.cu:33-49) plus the static-filter
    support bound replacing its dynamic blur-kernel re-sizing
    (base_dau_conv_layer.cpp:146-158,415-434)."""
    value = jnp.reshape(sigma, (-1,))[0]
    return jnp.clip(value, cfg.sigma_lower_bound, cfg.sigma_upper_bound)


def _filters(cfg: DAUConvSettings, sigma_value):
    return gaussian_filters(
        sigma_value,
        size=cfg.blur_size,
        single_dim_kernel=cfg.single_dim_kernel,
        forbid_positive_dim1=cfg.forbid_positive_dim1,
        unit_normalization=cfg.unit_normalization,
        square_unit_normalization=cfg.square_unit_normalization,
        dtype=jnp.dtype(jnp.result_type(sigma_value, jnp.float32)),
    )


def _aggregate(cfg: DAUConvSettings, x_blur, w, mu1, mu2, phi=None):
    if cfg.engine == "fourier":
        return fourier_engine.fourier_forward(
            x_blur, w, mu1, mu2, cfg.synth_kernel_size, cfg.use_interpolation,
            precision=cfg.lax_precision, phi=phi)
    return xla_engine.aggregate_forward(
        x_blur, w, mu1, mu2, cfg.synth_kernel_size, cfg.use_interpolation,
        precision=cfg.lax_precision)


def _build_phi(cfg: DAUConvSettings, spatial, w3m, mu13, mu23):
    """Bin-major spectral phase table shared by the fourier fwd + dx passes.

    Phase factors come from integer cos/sin tables (floor(mu) is bounded by
    the mu clip, so e^{i w floor(mu)} is a lookup realized as a skinny
    matmul instead of runtime transcendentals), exact to table roundoff
    (angles are f64 host-side)."""
    h, wd = spatial
    p1, p2, rb = fourier_engine.plan_bins(h, wd, cfg.synth_kernel_size)
    return fourier_engine.build_phi(w3m, mu13, mu23, p1, p2, rb,
                                    cfg.use_interpolation,
                                    phase_span=cfg.synth_kernel_size // 2 + 1,
                                    precision=cfg.lax_precision)


def _factor_filters(cfg: DAUConvSettings, sigma_value):
    """Separable 1D factorization of the blur filters (see
    gaussian.gaussian_factor_filters)."""
    return gaussian_factor_filters(
        sigma_value,
        size=cfg.blur_size,
        single_dim_kernel=cfg.single_dim_kernel,
        forbid_positive_dim1=cfg.forbid_positive_dim1,
        unit_normalization=cfg.unit_normalization,
        square_unit_normalization=cfg.square_unit_normalization,
        dtype=jnp.dtype(jnp.result_type(sigma_value, jnp.float32)),
    )


def _blur(cfg: DAUConvSettings, x, sigma_value, name: str):
    """Engine-dispatched blur. The fourier production engine uses the
    separable banded-matmul form (identical zero-pad semantics, runs as
    plain matmuls); the dense engine keeps the grouped depthwise conv."""
    if cfg.engine == "fourier":
        vecs, terms = _factor_filters(cfg, sigma_value)
        return rank1_blur(x, vecs, terms[name], precision=cfg.lax_precision)
    return depthwise_blur(x, _filters(cfg, sigma_value)[name],
                          precision=cfg.lax_precision)


def _blur_and_aggregate(cfg: DAUConvSettings, x, sigma_value, w, mu1, mu2,
                        phi=None, blur_name: str = "w"):
    """Blur + offset-and-sum, the engine-dispatched forward chain."""
    x_blur = _blur(cfg, x, sigma_value, blur_name)
    return _aggregate(cfg, x_blur, w, mu1, mu2, phi=phi)


def _forward_impl(cfg: DAUConvSettings, x, w, mu1, mu2, sigma, phi=None):
    w3, mu13, mu23, _ = _squeeze_params(w, mu1, mu2)
    mask = _unit_mask(*w3.shape, cfg.number_units_ignore, w3.dtype)
    if mask is not None:
        w3 = w3 * mask
    if phi is None and cfg.engine == "fourier":
        # one phi build path everywhere (integer tables, f64 host angles):
        # the primal-only call (inference without grad) matches the
        # _fwd_rule/table numerics exactly instead of diverging by the
        # runtime-trig build's roundoff
        phi = _build_phi(cfg, x.shape[-2:], w3.astype(x.dtype), mu13, mu23)
    return _blur_and_aggregate(cfg, x, _sigma_scalar(cfg, sigma),
                               w3, mu13, mu23, phi=phi)


def precompute_phi(cfg: DAUConvSettings, spatial, w, mu1, mu2,
                   dtype=None):
    """Prebuild the fourier engine's spectral phase table for FROZEN params.

    The phase table Phi[k,s,f] depends only on (w, mu1, mu2) and the input
    spatial shape - at serving time the params are constants, so Phi is a
    constant too. Building it once and passing it to `dau_conv2d_infer`
    removes the per-call build from the inference path entirely. The
    reference has no serving path (inference = the same op,
    README.md:37-39); this is the serving analogue of its "prefilter
    kernels cached until sigma changes" idea
    (base_dau_conv_layer.cpp:414-434) applied to the offset table.

    Args:
      cfg: settings with engine resolving to 'fourier' (ValueError otherwise
        - the dense engines have no phase table to cache).
      spatial: (H, W) of the inputs the op will serve.
      w, mu1, mu2: unit parameters, (1, S, G, F) or (S, G, F).
      dtype: table dtype; defaults to w's dtype (use the serving input
        dtype, e.g. jnp.bfloat16).

    Returns: (phire, phiim) bin-major tables to pass as
    `dau_conv2d_infer(..., phi=...)`.
    """
    if cfg.engine != "fourier":
        raise ValueError(
            f"precompute_phi requires engine='fourier', got {cfg.engine!r}")
    w3, mu13, mu23, _ = _squeeze_params(w, mu1, mu2)
    mask = _unit_mask(*w3.shape, cfg.number_units_ignore, w3.dtype)
    if mask is not None:
        w3 = w3 * mask
    dt = w3.dtype if dtype is None else dtype
    return _build_phi(cfg, tuple(spatial), w3.astype(dt), mu13, mu23)


def dau_conv2d_infer(cfg: DAUConvSettings, x, w, mu1, mu2, sigma, phi=None):
    """Forward-only DAU convolution for serving.

    Same numerics as `dau_conv2d_op` (it IS the same forward
    implementation), without the custom-VJP machinery, and with an optional
    prebuilt `phi` from `precompute_phi` so frozen-weight serving skips the
    per-call phase-table build. `phi` requires engine='fourier' and must
    have been built for x's spatial shape and dtype.
    """
    if phi is not None and cfg.engine != "fourier":
        raise ValueError(
            f"phi is a fourier-engine table; engine is {cfg.engine!r}")
    return _forward_impl(cfg, x, w, mu1, mu2, sigma, phi=phi)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def dau_conv2d_op(cfg: DAUConvSettings, x, w, mu1, mu2, sigma):
    """Displaced Aggregation Unit convolution.

    Args:
      cfg: static `DAUConvSettings`.
      x: (N, S, H, W) input, NCHW.
      w, mu1, mu2: unit parameters, (1, S, G, F) (reference layout,
        dau_conv.py:378-385) or (S, G, F).
      sigma: layer-shared Gaussian width; any shape broadcastable from a
        scalar (the reference passes it tiled to (1, S, G, F)).

    Returns: (N, F, H, W).
    """
    return _forward_impl(cfg, x, w, mu1, mu2, sigma)


def _fwd_rule(cfg, x, w, mu1, mu2, sigma):
    phi = None
    if cfg.engine == "fourier":
        # build the spectral phase table once; the bwd rule reuses it for the
        # input gradient (Phi(-mu, S<->F) == conj(Phi), see fourier_engine).
        w3, mu13, mu23, _ = _squeeze_params(w, mu1, mu2)
        mask = _unit_mask(*w3.shape, cfg.number_units_ignore, w3.dtype)
        if mask is not None:
            w3 = w3 * mask
        phi = _build_phi(cfg, x.shape[-2:], w3.astype(x.dtype), mu13, mu23)
    y = _forward_impl(cfg, x, w, mu1, mu2, sigma, phi=phi)
    # remat_phi: the phase table (2*B*S*F bytes/layer) is rebuilt by the
    # bwd rule instead of living in the residuals until the backward runs
    res_phi = None if cfg.remat_phi else phi
    return y, (x, w, mu1, mu2, sigma, res_phi)


def _reduce_to_shape(g, shape):
    """Sum-reduce a full gradient back to a broadcast-origin shape."""
    if g.shape == tuple(shape):
        return g
    ndiff = g.ndim - len(shape)
    if ndiff > 0:
        g = jnp.sum(g, axis=tuple(range(ndiff)))
    axes = tuple(i for i, (gd, sd) in enumerate(zip(g.shape, shape)) if sd != gd)
    if axes:
        g = jnp.sum(g, axis=axes, keepdims=True)
    return g.reshape(shape)


def _bwd_rule(cfg: DAUConvSettings, res, gy):
    x, w, mu1, mu2, sigma, phi = res
    w3, mu13, mu23, had_lead = _squeeze_params(w, mu1, mu2)
    s_ch, g_ch, f_ch = w3.shape
    mask = _unit_mask(s_ch, g_ch, f_ch, cfg.number_units_ignore, w3.dtype)
    w3m = w3 * mask if mask is not None else w3

    sigma_value = _sigma_scalar(cfg, sigma)

    if cfg.engine == "fourier" and phi is None:
        # rematerialized, not stashed (see DAUConvSettings.remat_phi)
        phi = _build_phi(cfg, x.shape[-2:], w3m.astype(x.dtype), mu13, mu23)

    # ---- input gradient: the forward engine applied to the error with
    # S<->F transposed params, negated offsets, and the mirrored blur filter
    # (reference base_dau_conv_layer.cu:294-325). The fourier engine needs no
    # transposed pass: it reuses the forward Phi conjugated. (Only with
    # interpolation: the 2 bilinear taps of -mu mirror those of mu exactly,
    # but the single floor-tap of interp-off does not - floor(-mu) !=
    # -floor(mu).)
    if cfg.engine == "fourier" and cfg.use_interpolation:
        gy_blur = _blur(cfg, gy, sigma_value, "error")
        dx = fourier_engine.fourier_input_grad(
            gy_blur, phi, cfg.synth_kernel_size, precision=cfg.lax_precision)
    else:
        dx = _blur_and_aggregate(
            cfg, gy, sigma_value,
            jnp.transpose(w3m, (2, 1, 0)),
            -jnp.transpose(mu13, (2, 1, 0)),
            -jnp.transpose(mu23, (2, 1, 0)),
            blur_name="error",
        )

    # ---- parameter gradients: blur x with the derivative filters, then
    # per unit the tap-weighted correlation with the error
    # (reference base_dau_conv_layer.cu:203-241 + finalize :330-356).
    gy_for_params = gy
    if cfg.unit_testing:
        h, w_sp = gy.shape[-2:]
        gy_for_params = gy * edge_gradient_mask(h, w_sp, gy.dtype)

    filter_names = ["w", "dmu1", "dmu2"] + (["dsigma"] if cfg.compute_sigma_grad else [])
    n, _, h, w_sp = x.shape
    if cfg.engine == "fourier":
        # spectral tap-gather: unit grads straight from the cross-spectra,
        # with no position table
        vecs, fterms = _factor_filters(cfg, sigma_value)
        xb = rank1_blur_stack(x, vecs, fterms, filter_names,
                              precision=cfg.lax_precision)  # (M, N, S, H, W)
        grads = fourier_engine.fourier_unit_grads(
            xb, gy_for_params, mu13, mu23, cfg.synth_kernel_size,
            cfg.use_interpolation, precision=cfg.lax_precision)
    else:
        filts = _filters(cfg, sigma_value)
        fstack = jnp.stack([filts[k] for k in filter_names])  # (M, kb, kb)
        m = fstack.shape[0]
        xb = depthwise_blur(x, fstack, precision=cfg.lax_precision)  # (N, S*M, H, W)
        xb = xb.reshape(n, s_ch, m, h, w_sp)
        xb = jnp.transpose(xb, (2, 0, 1, 3, 4))        # (M, N, S, H, W)
        table = xla_engine.grad_tables(xb, gy_for_params, cfg.synth_kernel_size,
                                       precision=cfg.lax_precision)
        grads = xla_engine.tap_gather(table, mu13, mu23, cfg.synth_kernel_size,
                                      cfg.use_interpolation)  # (M, S, G, F)

    lr = jnp.asarray(cfg.mu_learning_rate_factor, grads.dtype)
    dw = grads[0]
    dmu1 = grads[1] * w3m * lr
    dmu2 = grads[2] * w3m * lr
    if cfg.nan_guard_mu_grads:
        # reference finalize: NaN -> 0 on mu grads only
        # (base_dau_conv_layer.cu:354-356; lr multiply preserves 0/NaN, so
        # guarding after it is equivalent to the reference's before-lr order)
        dmu1 = dmath.clip_nan(dmu1)
        dmu2 = dmath.clip_nan(dmu2)
    if cfg.compute_sigma_grad:
        dsigma_full = grads[3] * w3m
    else:
        dsigma_full = jnp.zeros_like(w3)

    if mask is not None:
        # Ignored dummy units receive no gradient (reference zeroes them,
        # base_dau_conv_layer.cu:349-353); mu/sigma grads are already zero
        # via the masked w multiplication.
        dw = dw * mask

    if had_lead:
        dw, dmu1, dmu2, dsigma_full = (a[None] for a in (dw, dmu1, dmu2, dsigma_full))
    dsigma = _reduce_to_shape(dsigma_full, sigma.shape)
    return (dx.astype(x.dtype), dw.astype(w.dtype), dmu1.astype(mu1.dtype),
            dmu2.astype(mu2.dtype), dsigma.astype(sigma.dtype))


dau_conv2d_op.defvjp(_fwd_rule, _bwd_rule)
