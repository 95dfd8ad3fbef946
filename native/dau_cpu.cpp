// dau_cpu: native CPU reference engine for DAU convolutions.
//
// Role-parity with the reference's C++ CPU path (BaseDAUConvLayer::
// Forward_cpu / Backward_cpu, reference src/dau_conv/base_dau_conv_layer.cpp
// :637-1100): a framework-independent correctness oracle #2 and the fast
// backend for large differential-test matrices (the vectorized numpy oracle
// loops per unit in Python and dominates test time at reference-scale
// channel counts).
//
// Design differs from the reference CPU path on purpose: instead of
// im2col+GEMM blur (base_dau_conv_layer.cpp:680-691) it does direct
// correlation (the blur filter is tiny), and the offset-and-sum /
// offset-and-dot loops are written plane-at-a-time for cache locality.
// Semantics are pinned to the numpy oracle (ops/reference.py):
//   - zero-padded correlation blur,
//   - bilinear 4-tap sub-pixel shift with floor()-based integer offsets,
//   - zero-padding for shifted reads.
//
// Exposed C ABI (double precision; used via ctypes from
// dau_convnet/ops/cpp_oracle.py):
//   dau_blur2d            - (N*C, H, W) planes (x) filter -> out
//   dau_offset_and_sum    - blurred x, params -> y
//   dau_offset_and_dot    - blurred x, error, mus -> per-unit dots

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Zero-padded 'same' correlation of NC planes with one (kh, kw) filter.
void dau_blur2d(const double* x, int64_t planes, int64_t h, int64_t w,
                const double* filt, int64_t kh, int64_t kw, double* out) {
    const int64_t ph = kh / 2, pw = kw / 2;
    for (int64_t p = 0; p < planes; ++p) {
        const double* xp = x + p * h * w;
        double* op = out + p * h * w;
        for (int64_t i = 0; i < h; ++i) {
            for (int64_t j = 0; j < w; ++j) {
                double acc = 0.0;
                const int64_t i0 = i - ph, j0 = j - pw;
                const int64_t a_lo = i0 < 0 ? -i0 : 0;
                const int64_t a_hi = (i0 + kh > h) ? h - i0 : kh;
                const int64_t b_lo = j0 < 0 ? -j0 : 0;
                const int64_t b_hi = (j0 + kw > w) ? w - j0 : kw;
                for (int64_t a = a_lo; a < a_hi; ++a) {
                    const double* xr = xp + (i0 + a) * w;
                    const double* fr = filt + a * kw;
                    for (int64_t b = b_lo; b < b_hi; ++b) {
                        acc += fr[b] * xr[j0 + b];
                    }
                }
                op[i * w + j] = acc;
            }
        }
    }
}

namespace {

struct Tap {
    int64_t oy, ox;
    double tw;
};

// The up-to-4 bilinear taps of one unit (floor offsets + {0,1} deltas);
// matches ops/reference.py::_taps.
inline int unit_taps(double mu1, double mu2, bool interpolate, Tap taps[4]) {
    const double f1 = std::floor(mu1), f2 = std::floor(mu2);
    double a1 = mu1 - f1, a2 = mu2 - f2;
    if (!interpolate) {
        taps[0] = {static_cast<int64_t>(f2), static_cast<int64_t>(f1), 1.0};
        return 1;
    }
    int n = 0;
    for (int dy = 0; dy < 2; ++dy) {
        for (int dx = 0; dx < 2; ++dx) {
            const double wx = dx ? a1 : 1.0 - a1;
            const double wy = dy ? a2 : 1.0 - a2;
            taps[n++] = {static_cast<int64_t>(f2) + dy,
                         static_cast<int64_t>(f1) + dx, wx * wy};
        }
    }
    return 4;
}

// Accumulate scale * shifted(x) into y, reading zeros outside the plane.
inline void axpy_shifted(const double* x, double* y, int64_t h, int64_t w,
                         int64_t oy, int64_t ox, double scale) {
    if (scale == 0.0) return;
    const int64_t i_lo = oy < 0 ? -oy : 0;
    const int64_t i_hi = (h + oy > h) ? h - oy : h;  // min(h, h - oy)
    const int64_t j_lo = ox < 0 ? -ox : 0;
    const int64_t j_hi = (w + ox > w) ? w - ox : w;
    for (int64_t i = i_lo; i < i_hi; ++i) {
        const double* xr = x + (i + oy) * w + ox;
        double* yr = y + i * w;
        for (int64_t j = j_lo; j < j_hi; ++j) {
            yr[j] += scale * xr[j];
        }
    }
}

// Dot of shifted(x) with e over the valid (in-bounds) region.
inline double dot_shifted(const double* x, const double* e, int64_t h,
                          int64_t w, int64_t oy, int64_t ox) {
    const int64_t i_lo = oy < 0 ? -oy : 0;
    const int64_t i_hi = (h + oy > h) ? h - oy : h;
    const int64_t j_lo = ox < 0 ? -ox : 0;
    const int64_t j_hi = (w + ox > w) ? w - ox : w;
    double acc = 0.0;
    for (int64_t i = i_lo; i < i_hi; ++i) {
        const double* xr = x + (i + oy) * w + ox;
        const double* er = e + i * w;
        for (int64_t j = j_lo; j < j_hi; ++j) {
            acc += xr[j] * er[j];
        }
    }
    return acc;
}

}  // namespace

// y[n,f] += sum_{s,g} w[s,g,f] * shift(xb[n,s], mu1, mu2)
// xb: (N, S, H, W); w/mu: (S, G, F); y: (N, F, H, W) (pre-zeroed by caller).
void dau_offset_and_sum(const double* xb, int64_t n, int64_t s_ch, int64_t h,
                        int64_t w_sp, const double* w, const double* mu1,
                        const double* mu2, int64_t g_ch, int64_t f_ch,
                        int64_t g_used, int32_t interpolate, double* y) {
    const int64_t plane = h * w_sp;
    Tap taps[4];
    for (int64_t s = 0; s < s_ch; ++s) {
        for (int64_t g = 0; g < g_used; ++g) {
            for (int64_t f = 0; f < f_ch; ++f) {
                const int64_t u = (s * g_ch + g) * f_ch + f;
                const int nt = unit_taps(mu1[u], mu2[u], interpolate != 0, taps);
                for (int64_t b = 0; b < n; ++b) {
                    const double* xp = xb + (b * s_ch + s) * plane;
                    double* yp = y + (b * f_ch + f) * plane;
                    for (int t = 0; t < nt; ++t) {
                        axpy_shifted(xp, yp, h, w_sp, taps[t].oy, taps[t].ox,
                                     w[u] * taps[t].tw);
                    }
                }
            }
        }
    }
}

// out[s,g,f] = sum_{n,px,taps} tw * xb[n,s,px+off] * err[n,f,px]
// xb: (N, S, H, W); err: (N, F, H, W); out: (S, G, F) (pre-zeroed).
void dau_offset_and_dot(const double* xb, const double* err, int64_t n,
                        int64_t s_ch, int64_t h, int64_t w_sp,
                        const double* mu1, const double* mu2, int64_t g_ch,
                        int64_t f_ch, int64_t g_used, int32_t interpolate,
                        double* out) {
    const int64_t plane = h * w_sp;
    Tap taps[4];
    for (int64_t s = 0; s < s_ch; ++s) {
        for (int64_t g = 0; g < g_used; ++g) {
            for (int64_t f = 0; f < f_ch; ++f) {
                const int64_t u = (s * g_ch + g) * f_ch + f;
                const int nt = unit_taps(mu1[u], mu2[u], interpolate != 0, taps);
                double acc = 0.0;
                for (int64_t b = 0; b < n; ++b) {
                    const double* xp = xb + (b * s_ch + s) * plane;
                    const double* ep = err + (b * f_ch + f) * plane;
                    for (int t = 0; t < nt; ++t) {
                        acc += taps[t].tw *
                               dot_shifted(xp, ep, h, w_sp, taps[t].oy, taps[t].ox);
                    }
                }
                out[u] = acc;
            }
        }
    }
}

}  // extern "C"
