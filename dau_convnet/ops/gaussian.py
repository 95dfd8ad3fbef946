"""Gaussian aggregation-kernel precompute (pure jnp, fused by XLA).

JAX replacement for the reference's GPU kernel-precompute pipeline
(`BaseDAUKernelCompute::get_kernels`, reference
src/dau_conv/base_dau_conv_layer.cu:537-710): evaluates the layer-shared
Gaussian blur filter and its three analytic derivative filters
(d/dmu1, d/dmu2, d/dsigma) on a (K x K) grid, applies unit-sum (or
square-sum) normalization with the quotient-rule correction, and produces
the mirrored filter used for error backprop.

The reference recomputes these only when sigma changes
(base_dau_conv_layer.cpp:415-434); under jit the whole precompute is ~40
fused VPU ops and is recomputed each step at negligible cost (and stays
differentiable w.r.t. sigma).

Filter-size policy: the reference C++ sizes the blur kernel as
2*ceil(5*sigma)+1 (base_dau_conv_layer.cpp:146-147) while its numpy oracle
always uses 9x9 (plugins/tensorflow/tests/dau_conv_test.py:178). For
sigma=0.5 (the only tested/default value) the two agree to ~1e-14 since the
Gaussian vanishes beyond 5*sigma. Under jit the size must be static, so we
default to the reference-C++ rule evaluated on the *concrete* sigma at trace
time, with a floor of 9 to stay oracle-exact for small sigma.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def blur_kernel_size(sigma: float, min_size: int = 9) -> int:
    """Static blur-filter size, reference rule 2*ceil(5*sigma)+1.

    Mirrors reference base_dau_conv_layer.cpp:146-147; `min_size=9` keeps
    parity with the numpy oracle's fixed 9x9 grid for small sigma. Must be
    called on a concrete (non-traced) sigma at layer-construction time.
    """
    size = 2 * int(math.ceil(5.0 * float(sigma))) + 1
    size = max(size, min_size)
    if size > 33:
        # Reference hard limit: blur filter <= 17x17 (convolve.cu:40). We are
        # not bound by CUDA constant memory, but enormous sigmas indicate a
        # config error; cap generously.
        raise ValueError(
            f"sigma={sigma} requires a {size}x{size} blur filter; max supported is 33x33"
        )
    return size


def gaussian_filters(
    sigma: jax.Array,
    size: int = 9,
    *,
    single_dim_kernel: bool = False,
    forbid_positive_dim1: bool = False,
    unit_normalization: bool = True,
    square_unit_normalization: bool = False,
    dtype=jnp.float32,
):
    """Build the blur filter and its derivative filters.

    Returns a dict with keys: ``w`` (normalized blur filter), ``dmu1``,
    ``dmu2``, ``dsigma`` (quotient-rule-corrected derivative filters) and
    ``error`` (the 180-degree-rotated blur filter used for input-gradient
    backprop). All shaped (size, size), row = y axis, col = x axis.

    Semantics pinned to the reference numpy oracle `_get_filters`
    (dau_conv_test.py:177-220) and the GPU precompute
    (base_dau_conv_layer.cu:402-448, :605-683):

    - ``g = exp(-(x^2+y^2) / (2 sigma^2))`` on an integer grid centred at
      size//2; x varies along columns, y along rows.
    - ``single_dim_kernel`` zeroes all rows except the centre row
      (1D DAU along x; base_dau_conv_layer.cu:432-434).
    - ``forbid_positive_dim1`` zeroes x > 0 (base_dau_conv_layer.cu:436-438).
    - normalization divides by sum(g) (or sum(g^2) when
      ``square_unit_normalization``), and derivative filters get the quotient
      rule correction: d_norm = d/Z - g_norm * (sum(d)/Z).
    """
    sigma = jnp.asarray(sigma, dtype=dtype).reshape(())
    c = size // 2
    x = jnp.arange(size, dtype=dtype)[None, :] - c  # columns
    y = jnp.arange(size, dtype=dtype)[:, None] - c  # rows
    x = jnp.broadcast_to(x, (size, size))
    y = jnp.broadcast_to(y, (size, size))
    r2 = x * x + y * y

    sigma2_inv = 1.0 / (sigma * sigma)
    g = jnp.exp(-r2 * (0.5 * sigma2_inv))

    if single_dim_kernel:
        g = jnp.where(y == 0, g, 0.0)
    if forbid_positive_dim1:
        g = jnp.where(x > 0, 0.0, g)

    d_mu1 = x * sigma2_inv * g
    d_mu2 = y * sigma2_inv * g
    d_sigma = r2 * (sigma2_inv / sigma) * g

    # Normalization + quotient-rule derivative corrections, matching the
    # reference's three modes exactly (base_dau_conv_layer.cu:605-683):
    #   unit:   f = g / sum(g),   correction sums = sum(dm)
    #   square: f = g / sum(g^2), correction sums = 2 * sum(g * dm)
    #   none:   f = g,            no correction (sums forced to 0)
    if square_unit_normalization:
        z = jnp.sum(g * g)
        s1 = 2.0 * jnp.sum(g * d_mu1) / z
        s2 = 2.0 * jnp.sum(g * d_mu2) / z
        ss = 2.0 * jnp.sum(g * d_sigma) / z
    elif unit_normalization:
        z = jnp.sum(g)
        s1 = jnp.sum(d_mu1) / z
        s2 = jnp.sum(d_mu2) / z
        ss = jnp.sum(d_sigma) / z
    else:
        z = jnp.asarray(1.0, dtype)
        s1 = s2 = ss = jnp.asarray(0.0, dtype)

    # tiny mu sums are zeroed (reference caffe_gpu_clip_eps(1e-10),
    # base_dau_conv_layer.cu:663-665)
    s1 = jnp.where(jnp.abs(s1) > 1e-10, s1, 0.0)
    s2 = jnp.where(jnp.abs(s2) > 1e-10, s2, 0.0)

    g_n = g / z
    d_mu1_n = d_mu1 / z - g_n * s1
    d_mu2_n = d_mu2 / z - g_n * s2
    d_sigma_n = d_sigma / z - g_n * ss

    error = jnp.flip(jnp.flip(g_n, axis=0), axis=1)

    return {
        "w": g_n,
        "dmu1": d_mu1_n,
        "dmu2": d_mu2_n,
        "dsigma": d_sigma_n,
        "error": error,
    }


def gaussian_factor_filters(
    sigma: jax.Array,
    size: int = 9,
    *,
    single_dim_kernel: bool = False,
    forbid_positive_dim1: bool = False,
    unit_normalization: bool = True,
    square_unit_normalization: bool = False,
    dtype=jnp.float32,
):
    """The filters of `gaussian_filters` as separable rank-1/rank-2 terms.

    Every DAU blur filter is a product of 1D Gaussians (or their
    derivatives) along y and x, and the quotient-rule normalization
    corrections preserve that structure:

        w       = gy (x) gx                               (rank 1)
        dmu1    = gy (x) (x/s^2 * gx - s1 * gx)           (rank 1)
        dmu2    = (y/s^2 * gy - s2 * gy) (x) gx           (rank 1)
        dsigma  = (y^2/s^3 * gy - ss * gy) (x) gx
                  + gy (x) (x^2/s^3 * gx)                 (rank 2)
        error   = flip(gy) (x) flip(gx)                   (rank 1)

    This enables the blur to run as two small banded matmuls per term
    (`rank1_blur`) instead of a grouped NCHW depthwise convolution.

    Returns ``(vecs, terms)``: ``vecs`` maps vector names to (size,) arrays;
    ``terms`` maps each filter name to a list of ``(row_name, col_name)``
    pairs such that  filter = sum_r vecs[row] (outer) vecs[col],  matching
    `gaussian_filters` to float roundoff (differential-tested).
    """
    sigma = jnp.asarray(sigma, dtype=dtype).reshape(())
    c = size // 2
    t = jnp.arange(size, dtype=dtype) - c
    sigma2_inv = 1.0 / (sigma * sigma)
    g1 = jnp.exp(-t * t * (0.5 * sigma2_inv))

    gy = jnp.where(t == 0, g1, 0.0) if single_dim_kernel else g1
    gx = jnp.where(t > 0, 0.0, g1) if forbid_positive_dim1 else g1

    dx1 = t * sigma2_inv * gx          # x/s^2 * gx
    dy1 = t * sigma2_inv * gy
    sx1 = t * t * (sigma2_inv / sigma) * gx   # x^2/s^3 * gx
    sy1 = t * t * (sigma2_inv / sigma) * gy

    zy = jnp.sum(gy)
    zx = jnp.sum(gx)
    if square_unit_normalization:
        z = jnp.sum(gy * gy) * jnp.sum(gx * gx)
        s1 = 2.0 * jnp.sum(gy * gy) * jnp.sum(gx * dx1) / z
        s2 = 2.0 * jnp.sum(gy * dy1) * jnp.sum(gx * gx) / z
        ss = 2.0 * (jnp.sum(gy * sy1) * jnp.sum(gx * gx)
                    + jnp.sum(gy * gy) * jnp.sum(gx * sx1)) / z
    elif unit_normalization:
        z = zy * zx
        s1 = zy * jnp.sum(dx1) / z
        s2 = jnp.sum(dy1) * zx / z
        ss = (jnp.sum(sy1) * zx + zy * jnp.sum(sx1)) / z
    else:
        z = jnp.asarray(1.0, dtype)
        s1 = s2 = ss = jnp.asarray(0.0, dtype)
    s1 = jnp.where(jnp.abs(s1) > 1e-10, s1, 0.0)
    s2 = jnp.where(jnp.abs(s2) > 1e-10, s2, 0.0)

    # split the normalization so each factor stays O(1): rows get 1/zy-style
    # scaling only via the z division on the column side
    gyn = gy
    gxn = gx / z
    vecs = {
        "gy": gyn,
        "gx": gxn,
        "dx": dx1 / z - gxn * s1,
        "dy": dy1 - gy * s2,
        "sy": sy1 - gy * ss,
        "sx": sx1 / z,
        "gy_f": jnp.flip(gyn),
        "gx_f": jnp.flip(gxn),
    }
    terms = {
        "w": [("gy", "gx")],
        "dmu1": [("gy", "dx")],
        "dmu2": [("dy", "gx")],
        "dsigma": [("sy", "gx"), ("gy", "sx")],
        "error": [("gy_f", "gx_f")],
    }
    return vecs, terms


def _band_matrix(vec: jax.Array, n: int) -> jax.Array:
    """(n, n) banded matrix B[a, b] = vec[a - b + c] (zero outside the band):
    x @ B correlates the last axis of x with `vec` under zero padding."""
    size = vec.shape[0]
    c = size // 2
    idx = jnp.arange(n)
    d = idx[:, None] - idx[None, :] + c
    inband = (d >= 0) & (d < size)
    return jnp.where(inband, jnp.take(vec, d.clip(0, size - 1)), 0.0)


def rank1_blur(x: jax.Array, vecs, term_list, precision=jax.lax.Precision.HIGHEST):
    """Correlate NCHW ``x`` with a separable filter sum_r row_r (x) col_r.

    Exact same zero-padded semantics as `depthwise_blur`, expressed as two
    banded matmuls per rank-1 term (see `gaussian_factor_filters`). Column
    passes are shared between terms/filters by caching on the vector name:
    pass the same ``vecs`` dict for all filters of a layer.
    """
    h, w = x.shape[-2:]
    dtype = x.dtype
    out = None
    col_cache = {}
    for row_name, col_name in term_list:
        if col_name not in col_cache:
            cmat = _band_matrix(vecs[col_name], w).astype(dtype)
            col_cache[col_name] = jnp.matmul(x, cmat, precision=precision)
        t = col_cache[col_name]
        rmat = _band_matrix(vecs[row_name], h).astype(dtype)
        y = jnp.einsum("...hw,hy->...yw", t, rmat, precision=precision)
        out = y if out is None else out + y
    return out


def rank1_blur_stack(x: jax.Array, vecs, terms, names,
                     precision=jax.lax.Precision.HIGHEST):
    """Blur ``x`` (N, C, H, W) with each named filter -> (M, N, C, H, W).

    Matmul replacement for the reference's filter-batch convolve mode
    (convolve.cu:194-198) used to blur with all derivative kernels in one
    pass; column passes are shared across the M filters.
    """
    h, w = x.shape[-2:]
    dtype = x.dtype
    col_cache = {}
    outs = []
    for name in names:
        y = None
        for row_name, col_name in terms[name]:
            if col_name not in col_cache:
                cmat = _band_matrix(vecs[col_name], w).astype(dtype)
                col_cache[col_name] = jnp.matmul(x, cmat, precision=precision)
            t = col_cache[col_name]
            rmat = _band_matrix(vecs[row_name], h).astype(dtype)
            z = jnp.einsum("...hw,hy->...yw", t, rmat, precision=precision)
            y = z if y is None else y + z
        outs.append(y)
    return jnp.stack(outs)


def depthwise_blur(x: jax.Array, filt: jax.Array,
                   precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Correlate every (n, channel) plane of NCHW ``x`` with ``filt``, zero pad.

    JAX replacement for the reference's ArrayFire-derived
    `caffe_gpu_convolve2` blur engine (convolve.cu:48-131): one XLA grouped
    convolution (feature_group_count = C; cuDNN on the GPU). ``filt`` may be (kh, kw) for a single shared
    filter or (m, kh, kw) to apply m filters per channel (the reference's
    filter-batch K=4 mode used to blur with all derivative kernels in one
    pass, convolve.cu:194-198) - returning (N, C*m, H, W) with the m results
    of channel c at [c*m : (c+1)*m].
    """
    n, chan, h, w = x.shape
    if filt.ndim == 2:
        filt = filt[None]
    m, kh, kw = filt.shape
    # rhs layout OIHW with feature_group_count=chan: O = chan*m, I = 1.
    rhs = jnp.broadcast_to(filt[None], (chan, m, kh, kw)).reshape(chan * m, 1, kh, kw)
    rhs = rhs.astype(x.dtype)
    out = jax.lax.conv_general_dilated(
        x,
        rhs,
        window_strides=(1, 1),
        padding=((kh // 2, kh // 2), (kw // 2, kw // 2)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=chan,
        precision=precision,
    )
    return out
