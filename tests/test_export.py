"""Serving-path guard: jax.export round-trip of a DAU model.

The exported StableHLO artifact must rehydrate without model code and
reproduce the jitted forward exactly (examples/serve_inference.py is the
user-facing version of this flow).
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import export as jexport

from dau_convnet.nn import DAUConv2d
from flax import linen as nn


class _Tiny(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = DAUConv2d(filters=8, dau_units=(2, 1), max_kernel_size=9,
                      activation=nn.relu)(x)
        x = DAUConv2d(filters=8, dau_units=(1, 2), max_kernel_size=9,
                      engine="fourier")(x)
        return x.mean(axis=(2, 3))


def test_export_roundtrip_exact():
    rng = np.random.default_rng(0)
    model = _Tiny()
    x = jnp.asarray(rng.random((2, 4, 12, 12)), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)

    def forward(params, x):
        return model.apply(params, x)

    exported = jexport.export(jax.jit(forward))(
        params, jax.ShapeDtypeStruct(x.shape, x.dtype))
    served = jexport.deserialize(exported.serialize())
    y_ref = forward(params, x)
    y_served = served.call(params, x)
    np.testing.assert_allclose(np.asarray(y_served), np.asarray(y_ref),
                               atol=1e-6, rtol=1e-5)
