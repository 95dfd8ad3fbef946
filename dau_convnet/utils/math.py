"""Math utility parity shims (reference `caffe_gpu_*` family).

The reference ships a C++/CUDA math layer (include/dau_conv/util/
math_functions.hpp:16-209 plus kernels in math_functions.cu): cuBLAS
wrappers and bespoke elementwise kernels. Under XLA every one of these is a
one-line jnp expression that XLA fuses into surrounding computation - no
library needed. They are provided here under their reference names so users
porting code (and the component inventory) have a 1:1 mapping:

| reference (math_functions.cu) | here |
|---|---|
| caffe_gpu_clip_lower/upper (:242-289) | clip_lower / clip_upper |
| caffe_gpu_clip_eps (:292-310)         | clip_eps |
| caffe_gpu_clip_nan (:313-331)         | clip_nan |
| caffe_gpu_pad2d (:386-405)            | pad2d |
| caffe_gpu_amax via cublasIsamax (:407-422) | amax |
| caffe_gpu_sum via CUB segmented reduce (:360-372) | segmented_sum |
| caffe_gpu_gemm/gemv/axpy/scal/...     | jnp.dot / jnp ops (not wrapped) |
| im2col_cpu (util/im2col.cpp:20-57)    | im2col (CPU-oracle helper) |
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["clip_lower", "clip_upper", "clip_eps", "clip_nan", "pad2d",
           "amax", "segmented_sum", "im2col"]


def clip_lower(x, lower):
    """max(x, lower) elementwise (reference math_functions.cu:242-265)."""
    return jnp.maximum(x, lower)


def clip_upper(x, upper):
    """min(x, upper) elementwise (reference math_functions.cu:268-289)."""
    return jnp.minimum(x, upper)


def clip_eps(x, eps):
    """Zero values with |x| <= eps (reference math_functions.cu:292-310)."""
    return jnp.where(jnp.abs(x) > eps, x, jnp.zeros_like(x))


def clip_nan(x):
    """NaN -> 0; +-inf passes through (reference math_functions.cu:313-331
    is exactly `isnan(val) ? 0 : val`)."""
    return jnp.where(jnp.isnan(x), jnp.zeros((), x.dtype), x)


def pad2d(x, pad: int, value=0.0):
    """Pad the trailing two (spatial) dims (reference math_functions.cu:386-405)."""
    cfg = [(0, 0)] * (x.ndim - 2) + [(pad, pad), (pad, pad)]
    return jnp.pad(x, cfg, constant_values=value)


def amax(x):
    """max |x| (reference cublasIsamax wrapper, math_functions.cu:407-422).

    Note: the reference reads this back to the host each step to pick a
    CUDA kernel tier; under jit that dispatch is static - see utils.tiers.
    """
    return jnp.max(jnp.abs(x))


def segmented_sum(x, segment_size: int):
    """Sum over contiguous segments of the flattened input (reference CUB
    DeviceSegmentedReduce::Sum, math_functions.cu:360-372)."""
    flat = jnp.reshape(x, (-1, segment_size))
    return jnp.sum(flat, axis=-1)


def im2col(x, kh: int, kw: int, pad: int = 0, stride: int = 1):
    """Caffe-style im2col of a (C, H, W) plane -> (C*kh*kw, out_h*out_w)
    (reference util/im2col.cpp:20-57). Only used by oracle-style CPU code;
    the compute path uses direct convolution."""
    c, h, w = x.shape
    xp = jnp.pad(x, ((0, 0), (pad, pad), (pad, pad)))
    out_h = (h + 2 * pad - kh) // stride + 1
    out_w = (w + 2 * pad - kw) // stride + 1
    cols = []
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, i:i + out_h * stride:stride, j:j + out_w * stride:stride]
            cols.append(patch.reshape(c, out_h * out_w))
    col = jnp.stack(cols, axis=1)  # (C, kh*kw, L)
    return col.reshape(c * kh * kw, out_h * out_w)


def validate_dau_params(w, mu1, mu2, sigma, *, kernel_size: int,
                        component_border_bound: float = 0.01,
                        sigma_lower_bound: float = 0.3):
    """Host-side parameter sanity check (concrete arrays, between jit steps).

    Trace-time shapes are validated by the op itself; this covers the
    reference's *runtime* data guards, which cannot live under jit:
    the NaN check on mu (reference dau_conv_op.cpp:258-262), the offset
    bound vs the supported tier (dau_conv_forward.cpp:156-158), and the
    sigma lower bound (DAUConvSettings.sigma_lower_bound). Raises ValueError.
    """
    import numpy as np

    mu1 = np.asarray(mu1)
    mu2 = np.asarray(mu2)
    if np.isnan(mu1).any() or np.isnan(mu2).any():
        raise ValueError("NaN in mu1/mu2 - diverged training? (reference "
                         "guard dau_conv_op.cpp:258-262)")
    bound = kernel_size // 2 - component_border_bound
    worst = max(np.abs(mu1).max(), np.abs(mu2).max())
    if worst > bound + 1e-6:
        raise ValueError(
            f"max |mu| = {worst:.3f} exceeds the kernel bound {bound:.3f}; "
            "clip offsets (the DAUConv2d layer does this automatically)")
    sig = float(np.reshape(np.asarray(sigma), (-1,))[0])
    if not np.isfinite(sig) or sig < sigma_lower_bound:
        raise ValueError(f"sigma {sig} below lower bound {sigma_lower_bound}")
