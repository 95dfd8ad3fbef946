"""Seeded fuzz: random configs vs the native oracle (fast, broad coverage)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dau_convnet.ops import DAUConvSettings, cpp_oracle, dau_conv2d_op

from helpers import assert_matrix, random_case

pytestmark = pytest.mark.skipif(not cpp_oracle.available(),
                                reason="native oracle not built")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_configs(seed):
    rng = np.random.default_rng(1000 + seed)
    k = int(rng.choice([9, 17, 33]))
    case = dict(
        N=int(rng.integers(1, 4)),
        W=int(rng.integers(5, 24)),
        H=int(rng.integers(5, 24)),
        S=int(rng.integers(1, 9)),
        F=int(rng.integers(1, 9)),
        units=(int(rng.integers(1, 3)), int(rng.integers(1, 3))),
        max_kernel_size=k,
        max_offset_init=float(rng.uniform(0.5, k // 2)),
    )
    interp = bool(rng.integers(0, 2))
    x, w, mu1, mu2, sigma, err = random_case(rng, **case)
    cfg = DAUConvSettings(kernel_size=k, unit_testing=True,
                          use_interpolation=interp)
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1), w.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(x, w, mu1, mu2, sig, err):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a), x, w, mu1, mu2, sig)
        return y, vjp(err)

    y, grads = fwd_bwd(x, w, mu1, mu2, sig, jnp.asarray(err))
    gt_fwd = cpp_oracle.forward(x, w, mu1, mu2, [float(sigma)],
                                use_interpolation=interp)
    gt_bwd = cpp_oracle.backward(x, err, w, mu1, mu2, [float(sigma)],
                                 unit_testing=True, use_interpolation=interp)
    assert_matrix(np.asarray(y), gt_fwd, f"fwd[{case}]")
    for i, nm in enumerate(["dx", "dw", "dmu1", "dmu2", "dsig"]):
        assert_matrix(np.asarray(grads[i]), gt_bwd[i], f"{nm}[{case}]")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_extreme_tiers(seed):
    """Large kernel tiers on images SMALLER than the kernel, offsets out to
    the clip bound - the regime the round-3 extended fuzz found the fixed
    1e-7 absolute floor misfiring in (structurally-zero grads carry
    ~1e-6 * scale FFT-cancellation residue in the fourier engine; the
    dense engine produces them exactly). Runs both engines with the
    scale-aware tolerance (see assert_matrix)."""
    rng = np.random.default_rng(7000 + seed)
    k = int(rng.choice([33, 65]))
    case = dict(
        N=int(rng.integers(1, 3)),
        W=int(rng.integers(5, 20)),
        H=int(rng.integers(5, 20)),
        S=int(rng.integers(1, 6)),
        F=int(rng.integers(1, 6)),
        units=(int(rng.integers(1, 3)), int(rng.integers(1, 3))),
        max_kernel_size=k,
        # offsets out to the mu clip bound, far beyond the image
        max_offset_init=float(rng.uniform(k // 4, k // 2)),
    )
    interp = bool(rng.integers(0, 2))
    engine = ["xla", "fourier"][seed % 2]
    x, w, mu1, mu2, sigma, err = random_case(rng, **case)
    cfg = DAUConvSettings(kernel_size=k, unit_testing=True,
                          use_interpolation=interp, engine=engine)
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1),
                          w.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(x, w, mu1, mu2, sig, err):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a), x, w, mu1, mu2, sig)
        return y, vjp(err)

    y, grads = fwd_bwd(x, w, mu1, mu2, sig, jnp.asarray(err))
    gt_fwd = cpp_oracle.forward(x, w, mu1, mu2, [float(sigma)],
                                use_interpolation=interp)
    gt_bwd = cpp_oracle.backward(x, err, w, mu1, mu2, [float(sigma)],
                                 unit_testing=True, use_interpolation=interp)
    assert_matrix(np.asarray(y), gt_fwd, f"fwd[{engine},{case}]",
                  scale_aware=True)
    for i, nm in enumerate(["dx", "dw", "dmu1", "dmu2", "dsig"]):
        assert_matrix(np.asarray(grads[i]), gt_bwd[i],
                      f"{nm}[{engine},{case}]", scale_aware=True)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_random_sigma(seed):
    """Random sigma in [0.35, 1.3] (blur filter sized accordingly, up to the
    reference's 17x17 limit) with sigma-gradient enabled, both engines vs
    the C++ oracle - the rest of the suite mostly pins sigma=0.5, leaving
    the quotient-rule derivative-filter path (base_dau_conv_layer.cu:
    680-683) exercised at a single width."""
    from dau_convnet.ops.gaussian import blur_kernel_size

    rng = np.random.default_rng(9000 + seed)
    sigma = float(rng.uniform(0.35, 1.3))
    case = dict(
        N=int(rng.integers(1, 3)),
        W=int(rng.integers(8, 20)),
        H=int(rng.integers(8, 20)),
        S=int(rng.integers(1, 6)),
        F=int(rng.integers(1, 6)),
        units=(int(rng.integers(1, 3)), int(rng.integers(1, 3))),
        max_kernel_size=9,
        max_offset_init=3.0,
        sigma=sigma,
    )
    engine = ["xla", "fourier"][seed % 2]
    x, w, mu1, mu2, sigma, err = random_case(rng, **case)
    cfg = DAUConvSettings(kernel_size=9, unit_testing=True,
                          blur_size=blur_kernel_size(sigma),
                          compute_sigma_grad=True, engine=engine)
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1),
                          w.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(x, w, mu1, mu2, sig, err):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a), x, w, mu1, mu2, sig)
        return y, vjp(err)

    y, grads = fwd_bwd(x, w, mu1, mu2, sig, jnp.asarray(err))
    gt_fwd = cpp_oracle.forward(x, w, mu1, mu2, [float(sigma)],
                                blur_size=cfg.blur_size)
    gt_bwd = cpp_oracle.backward(x, err, w, mu1, mu2, [float(sigma)],
                                 unit_testing=True, blur_size=cfg.blur_size)
    assert_matrix(np.asarray(y), gt_fwd, f"fwd[sigma={sigma:.3f},{engine}]",
                  scale_aware=True)
    for i, nm in enumerate(["dx", "dw", "dmu1", "dmu2", "dsig"]):
        assert_matrix(np.asarray(grads[i]), gt_bwd[i],
                      f"{nm}[sigma={sigma:.3f},{engine}]", scale_aware=True)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_dummy_units(seed):
    """Odd unit counts -> trailing dummy unit with zero weight and no
    gradient (number_units_ignore, reference base_dau_conv_layer.cu:
    365-381), randomized over shapes/engines vs the C++ oracle."""
    rng = np.random.default_rng(11000 + seed)
    g_real = int(rng.integers(1, 4)) * 2 - 1          # odd: 1 or 3 or 5
    case = dict(
        N=int(rng.integers(1, 3)),
        W=int(rng.integers(8, 18)),
        H=int(rng.integers(8, 18)),
        S=int(rng.integers(1, 6)),
        F=int(rng.integers(1, 6)),
        units=(1, g_real + 1),                        # padded count
        max_kernel_size=9,
        max_offset_init=3.0,
        num_ignore=1,
    )
    engine = ["xla", "fourier"][seed % 2]
    x, w, mu1, mu2, sigma, err = random_case(rng, **case)
    cfg = DAUConvSettings(kernel_size=9, unit_testing=True,
                          number_units_ignore=1, engine=engine)
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1),
                          w.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(x, w, mu1, mu2, sig, err):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a), x, w, mu1, mu2, sig)
        return y, vjp(err)

    y, grads = fwd_bwd(x, w, mu1, mu2, sig, jnp.asarray(err))
    gt_fwd = cpp_oracle.forward(x, w, mu1, mu2, [float(sigma)],
                                num_dau_units_ignore=1)
    gt_bwd = cpp_oracle.backward(x, err, w, mu1, mu2, [float(sigma)],
                                 unit_testing=True, num_dau_units_ignore=1)
    assert_matrix(np.asarray(y), gt_fwd, f"fwd[dummy,{engine}]",
                  scale_aware=True)
    for i, nm in enumerate(["dx", "dw", "dmu1", "dmu2", "dsig"]):
        assert_matrix(np.asarray(grads[i]), gt_bwd[i],
                      f"{nm}[dummy,{engine}]", scale_aware=True)
    # dummy-unit gradients are exactly zeroed by the op
    for i in (1, 2, 3):
        assert float(np.abs(np.asarray(grads[i])[:, :, -1]).max()) == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_1d_variants(seed):
    """1D DAU (single_dim_kernel, mu2=0) and the causal mask
    (forbid_positive_dim1), randomized vs the C++ oracle (reference
    oracle masks: dau_conv_test.py:185-198)."""
    rng = np.random.default_rng(13000 + seed)
    causal = bool(seed % 2)
    case = dict(
        N=int(rng.integers(1, 3)),
        W=int(rng.integers(8, 20)),
        H=int(rng.integers(8, 20)),
        S=int(rng.integers(1, 6)),
        F=int(rng.integers(1, 6)),
        units=(int(rng.integers(1, 3)), int(rng.integers(1, 3))),
        max_kernel_size=9,
        max_offset_init=3.0,
    )
    engine = ["xla", "fourier"][seed % 2]
    x, w, mu1, mu2, sigma, err = random_case(rng, **case)
    mu2 = np.zeros_like(mu2)                         # 1D: no y displacement
    if causal:
        mu1 = -np.abs(mu1)                           # causal: x <= 0 only
    cfg = DAUConvSettings(kernel_size=9, unit_testing=True,
                          single_dim_kernel=True,
                          forbid_positive_dim1=causal, engine=engine)
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1),
                          w.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(x, w, mu1, mu2, sig, err):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a), x, w, mu1, mu2, sig)
        return y, vjp(err)

    y, grads = fwd_bwd(x, w, mu1, mu2, sig, jnp.asarray(err))
    kw = dict(single_dim_kernel=True, aggr_forbid_positive=causal)
    gt_fwd = cpp_oracle.forward(x, w, mu1, mu2, [float(sigma)], **kw)
    gt_bwd = cpp_oracle.backward(x, err, w, mu1, mu2, [float(sigma)],
                                 unit_testing=True, **kw)
    assert_matrix(np.asarray(y), gt_fwd, f"fwd[1d,{engine}]",
                  scale_aware=True)
    for i, nm in enumerate(["dx", "dw", "dmu1", "dmu2", "dsig"]):
        assert_matrix(np.asarray(grads[i]), gt_bwd[i],
                      f"{nm}[1d,causal={causal},{engine}]", scale_aware=True)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_normalization_modes(seed):
    """The two non-default blur normalizations (square-sum and none,
    reference base_dau_conv_layer.cu:605-655) through the FULL op - the
    filter-level differential test (test_utils) can't see an engine
    mishandling the mode. Both engines vs the C++ oracle."""
    rng = np.random.default_rng(15000 + seed)
    square = bool(seed % 2)
    case = dict(
        N=int(rng.integers(1, 3)),
        W=int(rng.integers(8, 18)),
        H=int(rng.integers(8, 18)),
        S=int(rng.integers(1, 5)),
        F=int(rng.integers(1, 5)),
        units=(int(rng.integers(1, 3)), int(rng.integers(1, 3))),
        max_kernel_size=9,
        max_offset_init=3.0,
    )
    engine = ["xla", "fourier"][(seed // 2) % 2]
    x, w, mu1, mu2, sigma, err = random_case(rng, **case)
    cfg = DAUConvSettings(kernel_size=9, unit_testing=True,
                          unit_normalization=square,
                          square_unit_normalization=square, engine=engine)
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1),
                          w.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(x, w, mu1, mu2, sig, err):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a), x, w, mu1, mu2, sig)
        return y, vjp(err)

    y, grads = fwd_bwd(x, w, mu1, mu2, sig, jnp.asarray(err))
    kw = dict(unit_normalization=square, square_unit_normalization=square)
    gt_fwd = cpp_oracle.forward(x, w, mu1, mu2, [float(sigma)], **kw)
    gt_bwd = cpp_oracle.backward(x, err, w, mu1, mu2, [float(sigma)],
                                 unit_testing=True, **kw)
    assert_matrix(np.asarray(y), gt_fwd, f"fwd[sq={square},{engine}]",
                  scale_aware=True)
    for i, nm in enumerate(["dx", "dw", "dmu1", "dmu2", "dsig"]):
        assert_matrix(np.asarray(grads[i]), gt_bwd[i],
                      f"{nm}[sq={square},{engine}]", scale_aware=True)
