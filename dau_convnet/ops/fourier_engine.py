"""Fourier engine: DAU aggregation as per-frequency contractions.

The spatial XLA engine (xla_engine.py) pays ks^2 dense-conv FLOPs per
(s, f, pixel) for what is mathematically a 4-tap gather - a structural
ks^2/(4G) FLOP overhead (~10x at ks=9, G=2) that round 1 identified as the
gap to the plain-conv baseline. This engine removes it EXACTLY (not an
approximation: same zero-padding semantics, validated to FFT roundoff
against the numpy oracle) by moving the aggregation to the frequency
domain, where the sub-pixel bilinear shift of the reference's
`perpare_weights_and_offsets` precompute (dau_conv_forward_core.hpp:
1858-2217) becomes an analytic 2-tap phase factor:

    shift by mu  <->  multiply by  (1-a) e^{i w f} + a e^{i w (f+1)},
                      f = floor(mu), a = mu - f

so the whole offset-and-sum collapses to one small complex matmul per
frequency bin:

    Y[k,n,f] = sum_s X[k,n,s] * Phi[k,s,f],
    Phi[k,s,f] = sum_g w[s,g,f] * py[k1] * px[k2]      (k = k1*rb + k2)

with FLOPs ~ 4*bins*N*S*F instead of 2*N*S*F*H*W*ks^2 - a 10-20x
reduction at AlexNet shapes. The backward position table is the same trick
on cross-spectra:

    T[s,f,p] = sum_{n,ij} xb[n,s,ij+p] err[n,f,ij]
             = partial-iDFT_p( sum_n X[k,s,n] conj(E[k,n,f]) )

Everything is real-arithmetic matmuls (complex hand-rolled as re/im pairs
so the production path can run bf16 matmuls with f32 accumulation); DFTs
are expressed as matrix products against precomputed (static) DFT
matrices, which keeps every stage dtype-flexible at these sizes (P <= 36).
Whether the FFT op (cuFFT) beats them on the GPU is not measured yet.
Zero-padding semantics match the oracle exactly: the
DFT matrices embed the zero padding (signal support H < transform length
P >= H + ks//2 guarantees no circular wrap).

Layout/precision rules:
- Phi is built directly in bin-major (B, S, F) layout as ONE fused
  product-reduce over g per re/im - a post-hoc transpose or per-g
  accumulation loop multiplies the build's memory traffic.
- Phase ANGLES, matmul accumulation and spectra are at least f32
  (`_acc`: f32 for bf16/f32 operands, f64 for f64 ones): angles reach
  ~2 pi * f * k (tens of radians), where bf16 quantization is O(0.25 rad) -
  the phase VALUES may then be cast to bf16 safely ([-1, 1] range).
- Cross-spectra are cast to the operand dtype in the matmul epilogue,
  halving the one large intermediate.

The input gradient needs no second phase table: Phi(-mu) = conj(Phi(mu))
exactly (floor/frac identities), so dx reuses the forward Phi conjugated
with the contraction taken over the F axis - the Fourier image of the
reference's "transpose channels + negate mu" backprop identity
(base_dau_conv_layer.cu:294-325). `dau_conv.py` stashes Phi in the VJP
residuals so forward and backward share one build.

Numerics note (round-3 extended fuzz): entries that are STRUCTURAL zeros
in the dense formulation - e.g. a unit whose whole window falls outside a
small image at the k=33/65 tiers with offsets near the clip bound - come
out of the spectral sums as ~3e-6 * tensor-scale cancellation residue
instead of exact 0.0 (many phase terms summing to zero in f32). This is
f32-roundoff-exact relative to the participating magnitudes; differential
tests at those configs use the scale-aware absolute floor
(tests/helpers.py::assert_matrix(scale_aware=True)).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["fourier_forward", "fourier_apply_phi", "fourier_input_grad",
           "fourier_unit_grads", "build_phi", "plan_bins"]


def _acc(dtype):
    """Accumulation dtype for `dtype` operands: f32 for bf16/f32, f64 for
    f64."""
    return jnp.promote_types(dtype, jnp.float32)


def plan_bins(h: int, w: int, ks: int):
    """Transform lengths (P1, P2) and rfft bin count for an H x W image with
    aggregation taps reaching ks//2: P >= H + ks//2 prevents circular wrap of
    the zero-padded correlation (validated exact in tests)."""
    c = ks // 2
    p1, p2 = h + c, w + c
    return p1, p2, p2 // 2 + 1


def _dft_mats(n_in: int, p: int, nbins: int, dtype):
    """(n_in, nbins) cos/sin matrices: X[k] = sum_i x[i] e^{-2 pi i k i / p}.

    Input support n_in < p embeds the zero padding for free."""
    i = np.arange(n_in)[:, None]
    k = np.arange(nbins)[None, :]
    ang = -2.0 * np.pi * i * k / p
    return jnp.asarray(np.cos(ang), dtype), jnp.asarray(np.sin(ang), dtype)


def _idft_mats(p1: int, p2: int, rb: int, out1, out2, dtype):
    """Partial inverse-rDFT matrices evaluating the real inverse transform at
    row indices `out1` and column indices `out2` (may be negative: circular).

    Returns (C, S) with shape (p1*rb, len(out1)*len(out2)) such that
    y = (Xre @ C - Xim @ S) recovers the real inverse at those positions,
    including the rfft conjugate-half weighting."""
    k1 = np.arange(p1)
    k2 = np.arange(rb)
    w2 = np.full(rb, 2.0)
    w2[0] = 1.0
    if p2 % 2 == 0:
        w2[-1] = 1.0
    o1 = np.asarray(out1)[:, None]
    o2 = np.asarray(out2)[None, :]
    ang1 = 2.0 * np.pi * k1[:, None, None, None] * o1[None, None, :, :] / p1
    ang2 = 2.0 * np.pi * k2[None, :, None, None] * o2[None, None, :, :] / p2
    ang = ang1 + ang2  # (p1, rb, len1, len2)
    coef = w2[None, :, None, None] / (p1 * p2)
    cmat = (np.cos(ang) * coef).reshape(p1 * rb, len(out1) * len(out2))
    smat = (np.sin(ang) * coef).reshape(p1 * rb, len(out1) * len(out2))
    return jnp.asarray(cmat, dtype), jnp.asarray(smat, dtype)


def _rdft2(x, p1: int, p2: int, rb: int, precision):
    """Batched 2D rDFT of (..., H, W) real input -> (..., p1*rb) complex as an
    (re, im) pair, via two matmul stages (zero padding embedded)."""
    h, w = x.shape[-2:]
    dtype = x.dtype
    c2, s2 = _dft_mats(w, p2, rb, dtype)
    are = jnp.matmul(x, c2, precision=precision)
    aim = jnp.matmul(x, s2, precision=precision)
    c1, s1 = _dft_mats(h, p1, p1, dtype)
    xre = (jnp.einsum("...hx,hy->...yx", are, c1, precision=precision)
           - jnp.einsum("...hx,hy->...yx", aim, s1, precision=precision))
    xim = (jnp.einsum("...hx,hy->...yx", are, s1, precision=precision)
           + jnp.einsum("...hx,hy->...yx", aim, c1, precision=precision))
    lead = x.shape[:-2]
    return xre.reshape(*lead, p1 * rb), xim.reshape(*lead, p1 * rb)


def _tap_phase(mu, p: int, nbins: int, use_interpolation: bool, out_dtype,
               bin_leading: bool = False):
    """Per-bin complex factor of the (bilinear) 1D shift-by-mu read, as
    (re, im), shape mu.shape + (nbins,) - or (nbins,) + mu.shape when
    bin_leading (built natively in that layout, so no post-hoc transpose
    of the factors is needed). ANGLES are computed in at least f32
    whatever out_dtype (see module docstring); results are cast."""
    mu32 = mu.astype(_acc(mu.dtype))
    f = jnp.floor(mu32)
    if use_interpolation:
        a = mu32 - f
    else:
        a = jnp.zeros_like(mu32)
    if bin_leading:
        k = jnp.arange(nbins, dtype=mu32.dtype).reshape(
            (nbins,) + (1,) * mu.ndim)
        f = f[None]
        b = a[None]
    else:
        k = jnp.arange(nbins, dtype=mu32.dtype)
        f = f[..., None]
        b = a[..., None]
    ang0 = (2.0 * np.pi / p) * f * k
    ang1 = ang0 + (2.0 * np.pi / p) * k
    re = (1.0 - b) * jnp.cos(ang0) + b * jnp.cos(ang1)
    im = (1.0 - b) * jnp.sin(ang0) + b * jnp.sin(ang1)
    return re.astype(out_dtype), im.astype(out_dtype)


def _phase_onehot(mu, span: int, use_interpolation: bool):
    """Bilinear one-hot weights over integer exponents:
    A[j, ...] = (1-a)[j == floor(mu)+span] + a[j == floor(mu)+span+1],
    shape (2*span+2,) + mu.shape, at least f32. floor(mu) clamped to
    [-span, span]."""
    mu32 = mu.astype(_acc(mu.dtype))
    f = jnp.floor(mu32)
    a = mu32 - f if use_interpolation else jnp.zeros_like(mu32)
    f = jnp.clip(f, -span, span)
    nj = 2 * span + 2
    jidx = f + span
    jio = jnp.arange(nj, dtype=mu32.dtype).reshape((nj,) + (1,) * mu.ndim)
    return (jnp.where(jio == jidx[None], 1.0 - a[None], 0.0)
            + jnp.where(jio == jidx[None] + 1.0, a[None], 0.0))


def _phase_table_host(p: int, nbins: int, span: int):
    """Static stacked [cos; sin] table (2*nbins, 2*span+2) for integer
    exponents e in [-span, span+1]: row k of cos-half is cos(2 pi k e / p).
    Computed f64 host-side."""
    nj = 2 * span + 2
    k = np.arange(nbins)[:, None]
    e = np.arange(nj)[None, :] - span
    ang = 2.0 * np.pi * k * e / p
    return np.concatenate([np.cos(ang), np.sin(ang)])


def _tap_phase_tables(mu, p: int, nbins: int, use_interpolation: bool,
                      out_dtype, span: int, precision):
    """`_tap_phase` (bin-leading) without runtime transcendentals.

    floor(mu) is an INTEGER in [-span, span] (mu is clipped to
    +-(ks//2 - border) before the op), so e^{2 pi i k floor(mu) / p} is a
    lookup into a static (nbins, 2*span+2) cos/sin table. The lookup is
    realized as one skinny matmul of the stacked [cos; sin] table against
    the bilinear one-hot weights  A[j, sgf] = (1-a)[j==f+span] + a[j==f+span+1]
    - compare-FMAs plus a matmul contraction over ~ks+3 entries replace
    ~4*nbins*S*G*F cos/sin evaluations. floor(mu) outside the span is
    clamped (out-of-contract inputs only; the trig path would wrap instead).

    Returns (re, im), each (nbins,) + mu.shape, cast to out_dtype.
    """
    nj = 2 * span + 2                      # exponents -span .. span+1
    onehot = _phase_onehot(mu, span, use_interpolation)
    tab = jnp.asarray(_phase_table_host(p, nbins, span), out_dtype)
    res = jax.lax.dot_general(
        tab, onehot.reshape(nj, -1).astype(out_dtype),
        (((1,), (0,)), ((), ())), precision=precision,
        preferred_element_type=_acc(out_dtype))
    res = res.reshape((2, nbins) + mu.shape).astype(out_dtype)
    return res[0], res[1]


def build_phi(w, mu1, mu2, p1: int, p2: int, rb: int,
              use_interpolation: bool = True, phase_span: int | None = None,
              precision=jax.lax.Precision.DEFAULT):
    """Phi[k,s,f] = sum_g w * py(k1) * px(k2), bin-major, k = k1*rb + k2.

    One fused broadcast-product + reduce over g per component (no per-g
    accumulation loop, no trailing transpose - both multiply the memory
    traffic; and never a 3-operand einsum over the phase factors, which
    lowers to many tiny batched matmuls).

    phase_span: when given (ks//2 + 1 for a ks-tap layer), the tap-phase
    factors come from integer cos/sin tables via a skinny matmul
    (_tap_phase_tables) instead of runtime transcendentals."""
    s, g, f = w.shape
    dtype = w.dtype
    if phase_span is not None:
        pyre, pyim = _tap_phase_tables(mu2, p1, p1, use_interpolation, dtype,
                                       phase_span, precision)  # (P1,S,G,F)
        pxre, pxim = _tap_phase_tables(mu1, p2, rb, use_interpolation, dtype,
                                       phase_span, precision)  # (rb,S,G,F)
    else:
        pyre, pyim = _tap_phase(mu2, p1, p1, use_interpolation, dtype,
                                bin_leading=True)  # (P1,S,G,F)
        pxre, pxim = _tap_phase(mu1, p2, rb, use_interpolation, dtype,
                                bin_leading=True)  # (rb,S,G,F)
    # bin-major factor views: (P1, 1, S, G, F) x (1, rb, S, G, F)
    yre = pyre[:, None]
    yim = pyim[:, None]
    xre = pxre[None]
    xim = pxim[None]
    wb = w[None, None]  # (1, 1, S, G, F)
    phire = jnp.sum(wb * (yre * xre - yim * xim), axis=3)  # (P1, rb, S, F)
    phiim = jnp.sum(wb * (yre * xim + yim * xre), axis=3)
    return phire.reshape(p1 * rb, s, f), phiim.reshape(p1 * rb, s, f)


def _bin_matmul(are, aim, bre, bim, precision, conj_b=False,
                contract=(2, 1)):
    """Per-bin complex contraction over one axis pair (batched over bins,
    dim 0). Default contracts A[k,m,c] x B[k,c,n] -> out[k,m,n]. 4 real
    batched matmuls, accumulated and returned in at least f32."""
    if conj_b:
        bim = -bim
    dn = (((contract[0],), (contract[1],)), ((0,), (0,)))

    def mm(x, y):
        return jax.lax.dot_general(x, y, dn, precision=precision,
                                   preferred_element_type=_acc(x.dtype))

    return mm(are, bre) - mm(aim, bim), mm(are, bim) + mm(aim, bre)


def fourier_apply_phi(x_blur, phire, phiim, h, w_sp, p1, p2, rb, precision,
                      contract_f: bool = False, conj_phi: bool = False):
    """Spectral core: transform x, contract against Phi per bin (four N-row
    per-bin matmuls), transform back. With contract_f=True the contraction
    runs over Phi's F axis (producing the S-channel output of the
    input-gradient path)."""
    dtype = x_blur.dtype
    xre, xim = _rdft2(x_blur, p1, p2, rb, precision)       # (N,C,B)
    xre_t = jnp.transpose(xre, (2, 0, 1))                  # (B,N,C)
    xim_t = jnp.transpose(xim, (2, 0, 1))
    if contract_f:
        yre, yim = _bin_matmul(xre_t, xim_t, phire, phiim, precision,
                               conj_b=not conj_phi, contract=(2, 2))
    else:
        yre, yim = _bin_matmul(xre_t, xim_t, phire, phiim, precision,
                               conj_b=conj_phi, contract=(2, 1))
    return _spectra_to_image(yre, yim, p1, p2, rb, h, w_sp,
                             precision).astype(dtype)


def _spectra_to_image(yre, yim, p1, p2, rb, h, w_sp, precision):
    """Partial inverse rDFT of per-bin spectra (B, N, C) -> (N, C, H, W)
    in the spectra's dtype: out[n,c,ij] = sum_k yre[k,n,c] C[k,ij] -
    yim[k,n,c] S[k,ij]."""
    n, cout = yre.shape[1], yre.shape[2]
    cmat, smat = _idft_mats(p1, p2, rb, np.arange(h), np.arange(w_sp),
                            yre.dtype)
    out = (jax.lax.dot_general(jnp.transpose(yre, (1, 2, 0)).reshape(-1, p1 * rb),
                               cmat, (((1,), (0,)), ((), ())),
                               precision=precision)
           - jax.lax.dot_general(jnp.transpose(yim, (1, 2, 0)).reshape(-1, p1 * rb),
                                 smat, (((1,), (0,)), ((), ())),
                                 precision=precision))
    return out.reshape(n, cout, h, w_sp)


def fourier_forward(x_blur, w, mu1, mu2, ks: int,
                    use_interpolation: bool = True,
                    precision=jax.lax.Precision.DEFAULT,
                    phi=None):
    """Offset-and-sum over (s, g) units via per-frequency contraction.

    Drop-in equivalent of xla_engine.aggregate_forward (same zero-padded
    bilinear-shift semantics, exact up to roundoff).

    Args:
      x_blur: (N, S, H, W) pre-blurred input.
      w, mu1, mu2: (S, G, F) unit parameters (w already dummy-masked).
      phi: optional prebuilt (phire, phiim) bin-major phase table.

    Returns: (N, F, H, W).
    """
    n, s, h, wd = x_blur.shape
    p1, p2, rb = plan_bins(h, wd, ks)
    dtype = x_blur.dtype
    if phi is None:
        phi = build_phi(w.astype(dtype), mu1, mu2, p1, p2, rb,
                        use_interpolation)
    return fourier_apply_phi(x_blur, phi[0], phi[1], h, wd, p1, p2, rb,
                             precision)


def fourier_input_grad(gy_blur, phi, ks: int,
                       precision=jax.lax.Precision.DEFAULT):
    """Input gradient from the (mirror-)blurred error and the FORWARD Phi:
    Phi(-mu, S<->F) = conj(Phi) with the contraction over F (reference
    identity base_dau_conv_layer.cu:294-325 in the spectral domain).

    gy_blur: (N, F, H, W) -> (N, S, H, W).
    """
    n, f, h, wd = gy_blur.shape
    p1, p2, rb = plan_bins(h, wd, ks)
    return fourier_apply_phi(gy_blur, phi[0], phi[1], h, wd, p1, p2, rb,
                             precision, contract_f=True)


def fourier_cross_spectra(x_blur_k, err, ks: int,
                          precision=jax.lax.Precision.DEFAULT):
    """Cross-spectra That[k] = sum_n X[k] conj(E[k]) as (tre, tim), each
    (B, M, S, F), plus the bin plan: the front half of
    `fourier_unit_grads`."""
    m, n, s, h, wd = x_blur_k.shape
    p1, p2, rb = plan_bins(h, wd, ks)
    dtype = x_blur_k.dtype
    spec_dtype = _acc(dtype) if precision == jax.lax.Precision.HIGHEST else dtype

    xre, xim = _rdft2(x_blur_k, p1, p2, rb, precision)      # (M,N,S,B)
    # Stack re/im along N: Re(X * conj(E)) = Xre*Ere + Xim*Eim and
    # Im(X * conj(E)) = Xim*Ere - Xre*Eim are single K=2N contractions.
    xs = jnp.concatenate([xre, xim], axis=1)                 # (M,2N,S,B)
    es_re, es_im = _err_spectrum_stacked(err, p1, p2, rb, precision)
    dn = (((1,), (0,)), ((3,), (2,)))  # contract 2N in place, batch B

    def mm(a, b):
        return jax.lax.dot_general(a, b, dn, precision=precision,
                                   preferred_element_type=_acc(dtype))

    tre = mm(xs, es_re).astype(spec_dtype)                   # (B,M,S,F)
    tim = mm(xs, es_im).astype(spec_dtype)
    return tre, tim, (p1, p2, rb)


def _err_spectrum_stacked(err, p1, p2, rb, precision):
    """Error spectrum with re/im stacked along N (see fourier_cross_spectra):
    (es_re, es_im), each (2N, F, B)."""
    ere, eim = _rdft2(err, p1, p2, rb, precision)           # (N,F,B)
    return (jnp.concatenate([ere, eim], axis=0),
            jnp.concatenate([-eim, ere], axis=0))


def _spectral_gather(tre, tim, mu1, mu2, p1, p2, rb, use_interpolation,
                     phase_span=None,
                     precision=jax.lax.Precision.DEFAULT):
    """grad[m,s,g,f] = sum_k coef_k (Re(phi_unit) tre - Im(phi_unit) tim)
    over cross-spectra (B, M, S, F) - the tap-gather in the spectral
    domain (the tap-weighted sum of inverse-DFT factors IS the unit's
    phase factor). phase_span: see `build_phi`."""
    b, m, s, f = tre.shape
    dtype = tre.dtype
    if phase_span is not None:
        pyre, pyim = _tap_phase_tables(mu2, p1, p1, use_interpolation, dtype,
                                       phase_span, precision)  # (P1,S,G,F)
        pxre, pxim = _tap_phase_tables(mu1, p2, rb, use_interpolation, dtype,
                                       phase_span, precision)  # (rb,S,G,F)
    else:
        pyre, pyim = _tap_phase(mu2, p1, p1, use_interpolation, dtype,
                                bin_leading=True)   # (P1,S,G,F)
        pxre, pxim = _tap_phase(mu1, p2, rb, use_interpolation, dtype,
                                bin_leading=True)   # (rb,S,G,F)
    w2 = np.full(rb, 2.0)
    w2[0] = 1.0
    if p2 % 2 == 0:
        w2[-1] = 1.0
    coef = jnp.asarray(w2 / (p1 * p2), dtype)

    tre5 = tre.reshape(p1, rb, m, s, 1, f)
    tim5 = tim.reshape(p1, rb, m, s, 1, f)
    yre = pyre[:, None, None, :, :, :]
    yim = pyim[:, None, None, :, :, :]
    xre = (pxre * coef[:, None, None, None])[None, :, None, :, :, :]
    xim = (pxim * coef[:, None, None, None])[None, :, None, :, :, :]
    # Re(phi) = yre*xre - yim*xim ; Im(phi) = yre*xim + yim*xre
    contrib = (tre5 * (yre * xre - yim * xim)
               - tim5 * (yre * xim + yim * xre))
    return jnp.sum(contrib.astype(_acc(dtype)), axis=(0, 1))


def fourier_unit_grads(x_blur_k, err, mu1, mu2, ks: int,
                       use_interpolation: bool = True,
                       precision=jax.lax.Precision.DEFAULT,
                       phase_tables: bool = True):
    """Per-unit parameter gradients WITHOUT materializing the position table:
    cross-spectra + the tap-gather applied in the spectral domain
    (_spectral_gather). One fused broadcast-reduce over the bins replaces
    a partial-iDFT matmul + one-hot tap-gather pair.

    Args:
      x_blur_k: (M, N, S, H, W) derivative-blurred inputs.
      err: (N, F, H, W) back-propagated error.
      phase_tables: use integer cos/sin tables for the unit phase factors
        (no runtime transcendentals; see `_tap_phase_tables`).

    Returns: (M, S, G, F) in at least f32 (same contract as tap_gather
    over grad_tables output).
    """
    tre, tim, (p1, p2, rb) = fourier_cross_spectra(x_blur_k, err, ks,
                                                   precision)
    return _spectral_gather(tre, tim, mu1, mu2, p1, p2, rb,
                            use_interpolation,
                            phase_span=(ks // 2 + 1) if phase_tables else None,
                            precision=precision)
