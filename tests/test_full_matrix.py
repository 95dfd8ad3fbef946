"""Full-scale differential matrix at the reference's exact test sizes.

These are the *unscaled* configs of the reference `test_DAUConvQuick`
(dau_conv_test.py:418-437), made tractable by the native C++ oracle
(ops/cpp_oracle.py); the smaller-channel matrix in test_op_vs_oracle.py
uses the pure-numpy oracle and runs everywhere.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dau_convnet.ops import DAUConvSettings, dau_conv2d_op, cpp_oracle

from helpers import assert_matrix, random_case

pytestmark = pytest.mark.skipif(not cpp_oracle.available(),
                                reason="native oracle not built (needs g++)")


def run_case(N, W, H, S, F, units, max_kernel_size, max_offset_init, seed=0):
    rng = np.random.default_rng(seed)
    x, w, mu1, mu2, sigma, err = random_case(
        rng, N=N, W=W, H=H, S=S, F=F, units=units,
        max_kernel_size=max_kernel_size, max_offset_init=max_offset_init)
    cfg = DAUConvSettings(kernel_size=max_kernel_size, unit_testing=True)
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1), w.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(x, w, mu1, mu2, sig, err):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a), x, w, mu1, mu2, sig)
        return y, vjp(err)

    y, (dx, dw, dmu1, dmu2, dsig) = fwd_bwd(x, w, mu1, mu2, sig, jnp.asarray(err))

    gt_fwd = cpp_oracle.forward(x, w, mu1, mu2, [float(sigma)])
    gt_bwd = cpp_oracle.backward(x, err, w, mu1, mu2, [float(sigma)],
                                 unit_testing=True)

    assert_matrix(np.asarray(y), gt_fwd, "fwd_output")
    assert_matrix(np.asarray(dx), gt_bwd[0], "bwd_error")
    assert_matrix(np.asarray(dw), gt_bwd[1], "bwd_w_grad")
    assert_matrix(np.asarray(dmu1), gt_bwd[2], "bwd_mu1_grad")
    assert_matrix(np.asarray(dmu2), gt_bwd[3], "bwd_mu2_grad")
    assert_matrix(np.asarray(dsig), gt_bwd[4], "bwd_sigma_grad")


# the reference test_DAUConvQuick configs, verbatim (dau_conv_test.py:418-437)
REFERENCE_QUICK = [
    dict(N=2, W=65, H=8, S=33, F=32, units=(1, 2), max_kernel_size=9, max_offset_init=3),
    dict(N=1, W=65, H=8, S=32, F=32, units=(1, 2), max_kernel_size=9, max_offset_init=3),
    dict(N=1, W=8, H=8, S=32, F=32, units=(1, 2), max_kernel_size=9, max_offset_init=3),
    dict(N=4, W=8, H=8, S=32, F=32, units=(1, 2), max_kernel_size=9, max_offset_init=3),
    dict(N=16, W=32, H=32, S=32, F=32, units=(2, 2), max_kernel_size=9, max_offset_init=3),
    dict(N=16, W=32, H=32, S=32, F=32, units=(2, 2), max_kernel_size=17, max_offset_init=6),
    dict(N=16, W=32, H=32, S=32, F=32, units=(2, 2), max_kernel_size=17, max_offset_init=3),
    dict(N=16, W=32, H=32, S=3, F=32, units=(2, 2), max_kernel_size=17, max_offset_init=3),
    dict(N=16, W=64, H=64, S=3, F=32, units=(2, 2), max_kernel_size=33, max_offset_init=10),
]


@pytest.mark.parametrize(
    "case", REFERENCE_QUICK,
    ids=lambda c: f"N{c['N']}_S{c['S']}_F{c['F']}_{c['W']}x{c['H']}_k{c['max_kernel_size']}")
def test_reference_quick_matrix(case):
    run_case(**case)


def test_reference_s64_f256():
    # the densest reference config (dau_conv_test.py:454)
    run_case(N=4, W=6, H=6, S=64, F=256, units=(2, 1), max_kernel_size=17,
             max_offset_init=8)


def test_reference_large_kernels_64px():
    # the reference test_DAUConv large-kernel cases (dau_conv_test.py:463-465)
    run_case(N=2, W=64, H=64, S=8, F=8, units=(2, 2), max_kernel_size=33,
             max_offset_init=10)
    run_case(N=2, W=64, H=64, S=4, F=4, units=(2, 2), max_kernel_size=65,
             max_offset_init=20)
