"""XLA engine: DAU aggregation as kernel synthesis + dense convolution.

Dense-convolution reformulation of the reference's hand-tuned CUDA engine
(`DAUConv_forward_pipeline_kernel`, dau_conv_forward_core.hpp:804-1600 and
`DAUConv_bwd_multi_pipeline_kernel`, dau_conv_backward_core.hpp:1019-2119).

Instead of translating the CUDA shared-memory gather pipeline (per-lane
dynamic addressing), the aggregation

    y[n,f] = sum_{s,g} w[s,g,f] * bilinear_shift(x_blur[n,s], mu1, mu2)

is expressed as a *dense convolution with a synthesized kernel*:

    K[s,f,ky,kx] = sum_g w[s,g,f] * ty[s,g,f,ky] * tx[s,g,f,kx]
    y = correlate(x_blur, K)        # one lax.conv (cuDNN on the GPU)

where ty/tx are one-hot bilinear tap vectors along the kernel axes
(the float mu decomposed into integer offset + interpolation weights,
exactly the reference's `perpare_weights_and_offsets` precompute,
dau_conv_forward_core.hpp:1858-2217 - but materialized as a tensor
contraction instead of warp-shuffled scalars). The parameter gradients
invert this: one conv-backward-filter contraction produces the full
position table, and the per-unit grads are the same one-hot einsum applied
to the table (the tap-gather).

Everything is static-shaped, jit-traceable, and lowers to dense
convolutions; XLA fuses the synthesis einsum and tap one-hots into surrounding ops.

Tap geometry: mu is bounded by +-(k//2 - border_bound) (layer-level clip,
reference dau_conv.py:188-195). floor(mu) then spans [-k//2-1, k//2-1] and
the +1 interpolation tap reaches +-(k//2+1), so the synthesized kernel uses
size k+2. (The reference instead *re-dispatches at runtime* to the next
kernel tier when offsets spill - dau_conv_op.cpp:242-256; under jit the
static k+2 bound replaces that data-dependent dispatch.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "synth_kernel_size",
    "tap_vectors",
    "synthesize_kernel",
    "aggregate_forward",
    "grad_tables",
    "tap_gather",
]


def synth_kernel_size(max_kernel_size: int) -> int:
    """Default synthesized-kernel size for a layer kernel bound (see module
    docstring); `DAUConvSettings.synth_kernel_size` computes the tight size
    when a static offset bound is known."""
    if max_kernel_size % 2 != 1:
        raise ValueError(f"max_kernel_size must be odd, got {max_kernel_size}")
    return max_kernel_size + 2


def tap_vectors(mu1, mu2, ks: int, use_interpolation: bool):
    """One-hot bilinear tap vectors along kernel x / y axes.

    Args:
      mu1, mu2: (S, G, F) float displacements (x and y).
      ks: synthesized-kernel size; must cover floor(|mu|) + 1.
      use_interpolation: bilinear (4-tap) vs floor-only (1-tap) placement.

    Returns:
      (ty, tx): each (S, G, F, ks), where
      sum_{ky,kx} ty[...,ky] * tx[...,kx] * x(i+ky-c, j+kx-c) equals the
      (bilinearly interpolated) read of x at (i + mu2, j + mu1).
    """
    c = ks // 2
    dtype = mu1.dtype
    f1 = jnp.floor(mu1)
    f2 = jnp.floor(mu2)
    if use_interpolation:
        a1 = mu1 - f1
        a2 = mu2 - f2
    else:
        a1 = jnp.zeros_like(mu1)
        a2 = jnp.zeros_like(mu2)

    pos = jnp.arange(ks, dtype=dtype)  # kernel coordinate axis
    t1 = c + f1[..., None]  # (S,G,F,1) target x position (exact small ints)
    t2 = c + f2[..., None]
    tx = (1.0 - a1)[..., None] * (pos == t1) + a1[..., None] * (pos == t1 + 1.0)
    ty = (1.0 - a2)[..., None] * (pos == t2) + a2[..., None] * (pos == t2 + 1.0)
    return ty.astype(dtype), tx.astype(dtype)


def _flat_taps(mu1, mu2, ks: int, use_interpolation: bool):
    """The (weight, flat-target-position) pairs of each unit's taps.

    Yields up to 4 (iw, tgt) with iw, tgt shaped like mu1; tgt indexes the
    flattened ks*ks kernel grid. Positions are exact small integers in the
    mu dtype.
    """
    c = ks // 2
    f1 = jnp.floor(mu1)
    f2 = jnp.floor(mu2)
    if use_interpolation:
        a1 = mu1 - f1
        a2 = mu2 - f2
        deltas = ((0, 0), (0, 1), (1, 0), (1, 1))
    else:
        a1 = jnp.zeros_like(mu1)
        a2 = jnp.zeros_like(mu2)
        deltas = ((0, 0),)
    base = (c + f2) * ks + (c + f1)
    out = []
    for dy, dx in deltas:
        wx = a1 if dx else 1.0 - a1
        wy = a2 if dy else 1.0 - a2
        out.append((wx * wy, base + (dy * ks + dx)))
    return out


def synthesize_kernel(w, mu1, mu2, ks: int, use_interpolation: bool = True):
    """K[s,f,ky,kx] = sum_g w[s,g,f] * bilinear-tap one-hot at (mu2, mu1).

    Built as fused elementwise compare-FMA passes over the (S, F, ks^2)
    output - NOT an einsum over one-hot vectors: that contraction lowers to
    ~S*F tiny [ks,G]x[G,ks] batched matmuls.
    """
    s, g, f = w.shape
    p = jnp.arange(ks * ks, dtype=mu1.dtype)
    kern = jnp.zeros((s, f, ks * ks), w.dtype)
    for iw, tgt in _flat_taps(mu1, mu2, ks, use_interpolation):
        contrib = (w * iw)[..., None] * (p == tgt[..., None])
        kern = kern + jnp.sum(contrib.astype(w.dtype), axis=1)
    return kern.reshape(s, f, ks, ks)


def aggregate_forward(x_blur, w, mu1, mu2, ks: int,
                      use_interpolation: bool = True,
                      precision=jax.lax.Precision.HIGHEST):
    """Offset-and-sum over (s, g) units as one dense conv.

    Args:
      x_blur: (N, S, H, W) pre-blurred input.
      w, mu1, mu2: (S, G, F) unit parameters (w already masked for ignored
        dummy units).

    Returns: (N, F, H, W).
    """
    kern = synthesize_kernel(w, mu1, mu2, ks, use_interpolation)  # (S,F,ks,ks)
    c = ks // 2
    rhs = jnp.transpose(kern, (1, 0, 2, 3))  # OIHW = (F, S, ks, ks)
    return jax.lax.conv_general_dilated(
        x_blur, rhs.astype(x_blur.dtype),
        window_strides=(1, 1),
        padding=((c, c), (c, c)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=precision,
    )


def grad_tables(x_blur_k, err, ks: int,
                precision=jax.lax.Precision.HIGHEST):
    """Full position-table of parameter gradients via conv-backward-filter.

    table[m,s,f,ky,kx] = sum_{n,i,j} x_blur_k[m,n,s,i+ky-c,j+kx-c] * err[n,f,i,j]

    i.e. for each derivative-blur m and each integer kernel position, the
    correlation of the blurred input with the back-propagated error. One XLA
    convolution: batch = (m, s) planes, channels = N, kernel = err.

    Args:
      x_blur_k: (M, N, S, H, W) input blurred with each of M derivative
        filters.
      err: (N, F, H, W).

    Returns: (M, S, F, ks, ks).
    """
    m, n, s, h, w_sp = x_blur_k.shape
    f = err.shape[1]
    c = ks // 2
    # (M, N, S, H, W) -> (M*S, N, H, W): batch-major m, then s.
    lhs = jnp.transpose(x_blur_k, (0, 2, 1, 3, 4)).reshape(m * s, n, h, w_sp)
    rhs = jnp.transpose(err, (1, 0, 2, 3))  # (F, N, H, W)
    table = jax.lax.conv_general_dilated(
        lhs, rhs.astype(lhs.dtype),
        window_strides=(1, 1),
        padding=((c, c), (c, c)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=precision,
    )  # (M*S, F, ks, ks)
    return table.reshape(m, s, f, ks, ks)


def tap_gather(table, mu1, mu2, ks: int, use_interpolation: bool = True,
               table_layout: str = "msfp"):
    """Per-unit gradients from a position table: the tap-gather.

    grad[m,s,g,f] = sum_taps iw * table[m,s,f, tap_position]

    Implemented as a fused one-hot multiply-reduce over the flat position
    axis (see synthesize_kernel for why not an einsum).

    table_layout: "msfp" = (M, S, F, ks, ks) (grad_tables output) or
    "pmsf" = (ks*ks, M, S, F) (the position-major layout the fourier
    engine's iDFT produces for free).
    """
    if table_layout == "pmsf":
        p2, m, s, f = table.shape
        g = mu1.shape[1]
        p = jnp.arange(ks * ks, dtype=mu1.dtype).reshape(-1, 1, 1, 1)
        mask = jnp.zeros((ks * ks, s, g, f), table.dtype)
        for iw, tgt in _flat_taps(mu1, mu2, ks, use_interpolation):
            mask = mask + (iw * (p == tgt)).astype(table.dtype)
        return jnp.sum(table.reshape(p2, m, s, 1, f) * mask[:, None],
                       axis=0)
    m, s, f = table.shape[:3]
    g = mu1.shape[1]
    tf = table.reshape(m, s, 1, f, ks * ks)
    p = jnp.arange(ks * ks, dtype=mu1.dtype)
    mask = jnp.zeros((s, g, f, ks * ks), table.dtype)
    for iw, tgt in _flat_taps(mu1, mu2, ks, use_interpolation):
        mask = mask + (iw[..., None] * (p == tgt[..., None])).astype(table.dtype)
    return jnp.sum(tf * mask[None], axis=-1)
