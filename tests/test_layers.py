"""Layer-level tests: flax DAUConv2d/DAUConv1d vs the numpy oracle.

Mirrors the reference `_run_DAUConv_forward_and_backward` /
`_run_DAUConv1d_forward_and_backward` flow (dau_conv_test.py:335-416,
:684-758): build the layer, pull its (clipped) parameters, run fwd+bwd, and
diff every output against the oracle at the reference tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from flax import linen as nn

from dau_convnet.nn import DAUConv1d, DAUConv2d, DAUGridMean

from helpers import assert_matrix, oracle_fwd_bwd


def _layer_fwd_bwd(op, x, err, mu_lr):
    params = op.init(jax.random.PRNGKey(0), x)

    @jax.jit
    def run(params, x, err):
        y, vjp = jax.vjp(lambda p, xx: op.apply(p, xx), params, x)
        grads, dx = vjp(err)
        return y, dx, grads

    y, dx, grads = run(params, x, jnp.asarray(err))
    p = params["params"]
    g = grads["params"]
    return (np.asarray(p["weights"]), np.asarray(p["mu1"]), np.asarray(p["mu2"]),
            float(np.asarray(p["sigma"])[0]),
            np.asarray(y), np.asarray(dx),
            {k: np.asarray(v) for k, v in g.items()})


def run_layer_case(N, W, H, S, F, units, max_kernel_size, max_offset_init,
                   *, single_dim=False, forbid_positive=False, seed=0,
                   sigma_trainable=False, engine="xla"):
    rng = np.random.default_rng(seed)
    x = rng.random((N, S, H, W)).astype(np.float32)
    err = rng.standard_normal((N, F, H, W)).astype(np.float32)
    mu_lr = 1000.0

    def uniform_init(key, shape, dtype=jnp.float32):
        return jax.random.uniform(key, shape, dtype,
                                  -max_offset_init, max_offset_init)

    cls = DAUConv1d if single_dim else DAUConv2d
    kwargs = dict(
        filters=F, dau_units=units, max_kernel_size=max_kernel_size,
        use_bias=False,
        weight_initializer=nn.initializers.normal(stddev=0.1),
        mu1_initializer=uniform_init,
        mu_learning_rate_factor=mu_lr,
        dau_sigma_trainable=sigma_trainable,
        unit_testing=True,
        engine=engine,
    )
    if not single_dim:
        kwargs["mu2_initializer"] = uniform_init
    else:
        kwargs["dau_aggregation_forbid_positive_dim1"] = forbid_positive
    op = cls(**kwargs)

    w, mu1, mu2, sigma, y, dx, g = _layer_fwd_bwd(op, x, err, mu_lr)
    num_ignore = op.num_dau_units_ignore

    # the layer clips mu before the op; the oracle sees clipped values
    bound = np.floor(max_kernel_size / 2.0) - 0.01
    mu1c = np.clip(mu1, -bound, bound)
    mu2c = np.zeros_like(mu2) if single_dim else np.clip(mu2, -bound, bound)

    gt_fwd, gt_bwd = oracle_fwd_bwd(
        x, w, mu1c, mu2c, sigma, err, num_ignore=num_ignore,
        single_dim=single_dim, forbid_positive=forbid_positive,
        unit_testing=True)

    # the layer clips mu inside apply; clip has zero gradient outside the
    # bounds (same as the reference's tf.clip_by_value, dau_conv.py:190-191),
    # so expected mu grads are masked at clipped positions
    mu1_pass = ((mu1 > -bound) & (mu1 < bound)).astype(np.float64)
    mu2_pass = ((mu2 > -bound) & (mu2 < bound)).astype(np.float64)

    assert_matrix(y, gt_fwd, "fwd_output")
    assert_matrix(dx, gt_bwd[0], "bwd_error")
    assert_matrix(g["weights"], gt_bwd[1], "bwd_w_grad")
    assert_matrix(g["mu1"], gt_bwd[2] * mu_lr * mu1_pass, "bwd_mu1_grad")
    if not single_dim:
        assert_matrix(g["mu2"], gt_bwd[3] * mu_lr * mu2_pass, "bwd_mu2_grad")
    if sigma_trainable:
        assert_matrix(g["sigma"], np.sum(gt_bwd[4], keepdims=True).reshape(1),
                      "bwd_sigma_grad")
    else:
        assert np.all(np.asarray(g["sigma"]) == 0.0)


def test_layer_2d_basic():
    run_layer_case(N=2, W=16, H=8, S=3, F=4, units=(1, 2), max_kernel_size=9,
                   max_offset_init=3)


def test_layer_2d_single_unit_rounding():
    # (1,1) -> 2 units with 1 dummy (reference test_DAUConvSingleUnit)
    run_layer_case(N=2, W=12, H=12, S=2, F=4, units=(1, 1), max_kernel_size=9,
                   max_offset_init=3, seed=1)


def test_layer_2d_offsets_beyond_bounds():
    # offsets initialized beyond kernel bounds exercise the layer clip
    # (reference test_DAUConvMemtest inits mu in +-10 on k=9,
    # dau_conv_test.py:652-653)
    run_layer_case(N=1, W=8, H=8, S=2, F=4, units=(2, 1), max_kernel_size=9,
                   max_offset_init=10, seed=2)


def test_layer_2d_sigma_trainable():
    run_layer_case(N=1, W=8, H=8, S=2, F=2, units=(2, 1), max_kernel_size=9,
                   max_offset_init=3, seed=3, sigma_trainable=True)


def test_layer_1d():
    # reference test_DAUConv1d (dau_conv_test.py:760-764)
    run_layer_case(N=2, W=16, H=8, S=3, F=4, units=(2, 2), max_kernel_size=9,
                   max_offset_init=3, single_dim=True, forbid_positive=True,
                   seed=4)


def test_layer_1d_fourier():
    # the 1D/causal masks live in the blur filter; the fourier aggregation
    # sees the same (mu2=0) geometry
    run_layer_case(N=2, W=16, H=8, S=3, F=4, units=(2, 2), max_kernel_size=9,
                   max_offset_init=3, single_dim=True, forbid_positive=True,
                   seed=4, engine="fourier")


def test_layer_sigma_trainable_fourier():
    run_layer_case(N=1, W=8, H=8, S=2, F=2, units=(2, 1), max_kernel_size=9,
                   max_offset_init=3, seed=3, sigma_trainable=True,
                   engine="fourier")


def test_stride_emulation():
    op = DAUConv2d(filters=4, dau_units=(2, 1), max_kernel_size=9, strides=2,
                   use_bias=False)
    op1 = DAUConv2d(filters=4, dau_units=(2, 1), max_kernel_size=9, strides=1,
                    use_bias=False)
    x = jnp.asarray(np.random.default_rng(0).random((1, 3, 8, 8)), jnp.float32)
    params = op.init(jax.random.PRNGKey(0), x)
    y2 = op.apply(params, x)
    y1 = op1.apply(params, x)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y1)[:, :, ::2, ::2])


def test_bias_and_activation_and_nhwc():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((2, 3, 8, 8)), jnp.float32)
    op = DAUConv2d(filters=4, dau_units=(2, 1), max_kernel_size=9,
                   use_bias=True, activation=nn.relu,
                   bias_initializer=nn.initializers.constant(0.25))
    params = op.init(jax.random.PRNGKey(1), x)
    y = op.apply(params, x)
    assert y.shape == (2, 4, 8, 8)
    assert np.all(np.asarray(y) >= 0.0)

    op_nhwc = DAUConv2d(filters=4, dau_units=(2, 1), max_kernel_size=9,
                        use_bias=True, activation=nn.relu,
                        bias_initializer=nn.initializers.constant(0.25),
                        data_format="channels_last")
    x_nhwc = jnp.transpose(x, (0, 2, 3, 1))
    y_nhwc = op_nhwc.apply(params, x_nhwc)
    np.testing.assert_allclose(np.asarray(y_nhwc),
                               np.transpose(np.asarray(y), (0, 2, 3, 1)),
                               rtol=1e-6, atol=1e-6)


def test_dau_grid_mean_values():
    # grid init spreads units evenly in [-max, max]
    # (reference README.md:192-202)
    init = DAUGridMean((2, 2), max_value=3.0, dau_unit_axis=2)
    vals = np.asarray(init(None, (1, 2, 4, 3)))
    assert vals.shape == (1, 2, 4, 3)
    per_unit = vals[0, 0, :, 0]
    # units (u0=2, u1=2): mu1 varies along axis u1 -> pattern [a, b, a, b]
    assert per_unit[0] == per_unit[2] and per_unit[1] == per_unit[3]
    assert -3.0 <= per_unit.min() <= per_unit.max() <= 3.0
    assert np.isclose(per_unit[0], -per_unit[1])


def test_param_shapes_and_dummy_unit_zeroing():
    op = DAUConv2d(filters=4, dau_units=(1, 1), max_kernel_size=9)
    x = jnp.ones((1, 3, 8, 8), jnp.float32)
    params = op.init(jax.random.PRNGKey(0), x)["params"]
    assert params["weights"].shape == (1, 3, 2, 4)
    assert op.num_dau_units_ignore == 1
    # dummy (last) unit weights are zero-initialized via ZeroNLast
    assert np.all(np.asarray(params["weights"])[:, :, -1, :] == 0.0)
    assert params["sigma"].shape == (1,)


def test_constraints_and_regularizers():

    def unit_norm_constraint(w):
        return w / (jnp.abs(w).max() + 1e-9)

    op = DAUConv2d(filters=4, dau_units=(2, 1), max_kernel_size=9,
                   use_bias=False,
                   weight_constraint=unit_norm_constraint,
                   weight_regularizer=lambda w: 0.5 * jnp.sum(w ** 2),
                   mu1_regularizer=lambda m: jnp.sum(jnp.abs(m)))
    x = jnp.ones((1, 3, 8, 8), jnp.float32)
    params = op.init(jax.random.PRNGKey(0), x)
    y = op.apply(params, x)
    assert y.shape == (1, 4, 8, 8)

    reg = op.regularization_loss(params["params"])
    expected = (0.5 * np.sum(np.asarray(params["params"]["weights"]) ** 2)
                + np.sum(np.abs(np.asarray(params["params"]["mu1"]))))
    np.testing.assert_allclose(float(reg), expected, rtol=1e-6)


def test_dau_conv1d_functional_wrapper():
    from dau_convnet.nn import dau_conv1d

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x):
            return dau_conv1d(x, 4, dau_units=(2, 1), max_kernel_size=9,
                              dau_aggregation_forbid_positive_dim1=True)

    net = Net()
    x = jnp.asarray(np.random.default_rng(0).random((1, 3, 4, 16)), jnp.float32)
    params = net.init(jax.random.PRNGKey(0), x)
    y = net.apply(params, x)
    assert y.shape == (1, 4, 4, 16)
    # mu2 exists but is pinned to zero by the 1D layer
    assert "mu2" in params["params"]["DAUConv1d_0"]


def test_validate_dau_params():
    import pytest
    from dau_convnet.utils.math import validate_dau_params

    good = dict(w=np.ones((1, 2, 2, 3)), mu1=np.ones((1, 2, 2, 3)),
                mu2=-np.ones((1, 2, 2, 3)), sigma=np.array([0.5]))
    validate_dau_params(**good, kernel_size=9)

    bad = dict(good, mu1=np.full((1, 2, 2, 3), np.nan))
    with pytest.raises(ValueError, match="NaN"):
        validate_dau_params(**bad, kernel_size=9)
    bad = dict(good, mu2=np.full((1, 2, 2, 3), 7.0))
    with pytest.raises(ValueError, match="exceeds"):
        validate_dau_params(**bad, kernel_size=9)
    bad = dict(good, sigma=np.array([0.05]))
    with pytest.raises(ValueError, match="sigma"):
        validate_dau_params(**bad, kernel_size=9)


def test_project_dau_params():
    """project_dau_params clips sigma/mu leaves into their valid ranges
    (functional analogue of the reference's in-place bounds guard,
    base_dau_conv_layer.cu:33-49) and leaves everything else alone."""
    from dau_convnet.nn import project_dau_params

    params = {
        "dau1": {"sigma": jnp.asarray([0.1]),
                 "mu1": jnp.asarray([[5.0, -5.0]]),
                 "mu2": jnp.asarray([[0.5, 2.0]]),
                 "weights": jnp.asarray([9.9])},
        "fc": {"kernel": jnp.asarray([7.0])},
    }
    out = project_dau_params(params, kernel_size=9)
    bound = 4 - 0.01
    np.testing.assert_allclose(np.asarray(out["dau1"]["sigma"]), [0.3])
    np.testing.assert_allclose(np.asarray(out["dau1"]["mu1"]),
                               [[bound, -bound]])
    np.testing.assert_allclose(np.asarray(out["dau1"]["mu2"]), [[0.5, 2.0]])
    np.testing.assert_allclose(np.asarray(out["dau1"]["weights"]), [9.9])
    np.testing.assert_allclose(np.asarray(out["fc"]["kernel"]), [7.0])
    top = float(project_dau_params(
        {"s": {"sigma": jnp.asarray([2.5])}}, kernel_size=9)["s"]["sigma"][0])
    np.testing.assert_allclose(top, 1.6, rtol=1e-6)
