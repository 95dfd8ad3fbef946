"""Utility tests: tiers, math shims, gaussian filter properties, config."""

import numpy as np
import jax.numpy as jnp
import pytest

from dau_convnet.ops import DAUConvSettings, gaussian_filters
from dau_convnet.ops.gaussian import blur_kernel_size
from dau_convnet.utils import snap_kernel_tier, tier_for_params
from dau_convnet.utils import math as dmath


def test_kernel_tiers():
    # reference tier rule: kernel >= 2*offset+1, tiers {9,17,33,65}
    # (dau_conv_forward.cpp:147-164)
    assert snap_kernel_tier(3) == 9
    assert snap_kernel_tier(4) == 9
    assert snap_kernel_tier(4.2) == 17
    assert snap_kernel_tier(8) == 17
    assert snap_kernel_tier(10) == 33
    assert snap_kernel_tier(20) == 65
    assert snap_kernel_tier(32) == 65
    with pytest.raises(ValueError):
        snap_kernel_tier(33)  # reference hard limit: 32 px


def test_tier_for_params():
    mu1 = np.array([1.0, -3.5])
    mu2 = np.array([0.5, 2.0])
    assert tier_for_params(mu1, mu2) == 9


def test_settings_synth_kernel_size():
    # border_bound 0.01 keeps |mu| <= k//2 - 0.01, so floor(|mu|)+1 <= k//2
    # and the synthesized kernel equals the layer kernel size
    assert DAUConvSettings(kernel_size=9).synth_kernel_size == 9
    assert DAUConvSettings(kernel_size=9, static_max_offset=3.0).synth_kernel_size == 9
    assert DAUConvSettings(kernel_size=9, static_max_offset=2.0).synth_kernel_size == 7
    # border_bound 0 admits mu = k//2 exactly; the +1 tap spills one position
    assert DAUConvSettings(kernel_size=9, component_border_bound=0.0).synth_kernel_size == 11
    assert DAUConvSettings(kernel_size=17).synth_kernel_size == 17


def test_blur_kernel_size():
    assert blur_kernel_size(0.5) == 9   # floor at oracle size
    assert blur_kernel_size(0.8) == 9   # 2*ceil(4)+1 = 9
    assert blur_kernel_size(1.5) == 17  # 2*ceil(7.5)+1 = 17


def test_gaussian_filter_properties():
    f = gaussian_filters(jnp.float32(0.7), size=9)
    # unit normalization: blur filter sums to 1
    np.testing.assert_allclose(float(jnp.sum(f["w"])), 1.0, rtol=1e-6)
    # quotient-rule-corrected derivative filters sum to ~0
    for k in ("dmu1", "dmu2", "dsigma"):
        assert abs(float(jnp.sum(f[k]))) < 1e-5
    # error filter is the 180-degree rotation
    np.testing.assert_allclose(np.asarray(f["error"]),
                               np.asarray(f["w"])[::-1, ::-1], rtol=1e-6)


def test_gaussian_filter_masks():
    f1d = gaussian_filters(jnp.float32(0.5), size=9, single_dim_kernel=True)
    w = np.asarray(f1d["w"])
    assert np.all(w[np.arange(9) != 4, :] == 0)  # only centre row
    fneg = gaussian_filters(jnp.float32(0.5), size=9, forbid_positive_dim1=True)
    w = np.asarray(fneg["w"])
    assert np.all(w[:, 5:] == 0)  # x > 0 zeroed


def test_math_shims():
    x = jnp.asarray([[1.0, -2.0, float("nan"), 1e-9]])
    assert float(dmath.amax(x[:, :2])) == 2.0
    np.testing.assert_array_equal(np.asarray(dmath.clip_nan(x))[0, 2], 0.0)
    assert float(dmath.clip_eps(x, 1e-6)[0, 3]) == 0.0
    assert float(dmath.clip_lower(x, 0.0)[0, 1]) == 0.0
    assert float(dmath.clip_upper(x, 0.5)[0, 0]) == 0.5
    padded = dmath.pad2d(jnp.ones((1, 2, 2)), 1)
    assert padded.shape == (1, 4, 4) and float(padded[0, 0, 0]) == 0.0
    seg = dmath.segmented_sum(jnp.arange(6.0), 3)
    np.testing.assert_allclose(np.asarray(seg), [3.0, 12.0])


def test_im2col_matches_direct_conv():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((2, 5, 6)), jnp.float32)
    filt = jnp.asarray(rng.random((2, 3, 3)), jnp.float32)
    col = dmath.im2col(x, 3, 3, pad=1)  # (2*9, 30)
    y = (filt.reshape(1, -1) @ col).reshape(5, 6)
    # direct correlation
    xp = np.pad(np.asarray(x), ((0, 0), (1, 1), (1, 1)))
    ref = np.zeros((5, 6))
    for c in range(2):
        for i in range(3):
            for j in range(3):
                ref += np.asarray(filt)[c, i, j] * xp[c, i:i + 5, j:j + 6]
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-5)


def test_settings_dead_fields_accepted():
    # merge_* are dead in the reference (merge_components commented out,
    # base_dau_conv_layer.cu:28-30); accepted as no-ops for API parity
    cfg = DAUConvSettings(merge_iteration_step=100, merge_threshold=0.5,
                          mean_iteration_step=1, sigma_iteration_step=1)
    assert cfg.merge_iteration_step == 100


@pytest.mark.parametrize("unit_norm,square_norm", [
    (True, False), (False, True), (False, False), (True, True)])
@pytest.mark.parametrize("single_dim,forbid_pos", [
    (False, False), (True, False), (True, True)])
def test_gaussian_factor_filters_match_dense(unit_norm, square_norm,
                                             single_dim, forbid_pos):
    """Every (vecs, terms) factorization reconstructs the dense filters of
    `gaussian_filters` across ALL normalization modes (the fourier-engine
    oracle matrix only exercises default unit normalization; this pins the
    square/none branches too - round-2 advisory)."""
    from dau_convnet.ops.gaussian import gaussian_factor_filters

    for sigma in (0.5, 0.8, 1.3):
        dense = gaussian_filters(
            jnp.float32(sigma), size=9, single_dim_kernel=single_dim,
            forbid_positive_dim1=forbid_pos, unit_normalization=unit_norm,
            square_unit_normalization=square_norm)
        vecs, terms = gaussian_factor_filters(
            jnp.float32(sigma), size=9, single_dim_kernel=single_dim,
            forbid_positive_dim1=forbid_pos, unit_normalization=unit_norm,
            square_unit_normalization=square_norm)
        for name, pairs in terms.items():
            rec = sum(np.outer(np.asarray(vecs[r], np.float64),
                               np.asarray(vecs[c], np.float64))
                      for r, c in pairs)
            got = np.asarray(dense[name], np.float64)
            np.testing.assert_allclose(
                rec, got, rtol=2e-5, atol=1e-7,
                err_msg=f"{name} sigma={sigma} unit={unit_norm} "
                        f"square={square_norm} 1d={single_dim}")


def test_bench_time_chained_tiny_iters():
    """bench.time_chained must survive iters < 5 (the short-run length is
    iters // 5, which was 0 and divided by zero before the floor)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import bench
    finally:
        sys.path.pop(0)

    def make_step(c):
        x, = c
        return (x * 1.000001,)

    dt, pairs_ms, compile_s = bench.time_chained(
        make_step, (jnp.ones((4, 4)),), iters=2, pairs=1)
    assert np.isfinite(dt) and dt > 0
    assert len(pairs_ms) == 1 and compile_s >= 0


def test_retier_offset_policy():
    """Both directions of the between-epochs re-jit policy (the host-side
    replacement for the reference's per-step amax tier dispatch,
    dau_conv_op.cpp:223-256): grow immediately on any excess, shrink only
    past the hysteresis slack, never exceed the kernel's own bound."""
    from dau_convnet.utils.tiers import retier_offset

    # grow: live exceeds the promise -> new bound covers it (+0.5 slack)
    assert retier_offset(2.2, 2.0, kernel_size=9) == 3.0
    # grow beyond the kernel cap saturates at k//2
    assert retier_offset(6.0, 3.0, kernel_size=9) == 4.0
    # steady state: inside the promise, inside the hysteresis -> no re-jit
    assert retier_offset(2.8, 3.0, kernel_size=9) is None
    # live below current but snapped (ceil(1.7+0.5)=3) above it: hold steady
    assert retier_offset(1.7, 2.0, kernel_size=9) is None
    # shrink: offsets contracted well below the promise
    assert retier_offset(0.8, 3.0, kernel_size=9) == 2.0
    assert retier_offset(0.3, 2.0, kernel_size=9) == 1.0
    # flap guard: live just below the boundary does not shrink
    assert retier_offset(2.6, 3.0, kernel_size=9) is None
