"""Serving-path example: AOT-export a DAU model and run batched inference.

The reference has no serving story (inference went through the same TF
session as training). The equivalent here is `jax.export`: trace +
lower the jitted forward once, serialize the StableHLO artifact, and
rehydrate it in a serving process with no Python model code - the
round-trip below proves the DAU custom-VJP op and both engines lower to a
self-contained artifact.

Run:  python examples/serve_inference.py
"""

import os
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import export as jexport

from dau_convnet.models import DAUCifarNet
from dau_convnet.utils.device import configure_compile_cache


def main():
    configure_compile_cache(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rng = np.random.default_rng(0)
    model = DAUCifarNet(train=False)
    x_spec = jax.ShapeDtypeStruct((8, 3, 32, 32), jnp.float32)
    x = jnp.asarray(rng.random(x_spec.shape), x_spec.dtype)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)

    # --- export: trace the jitted forward into a serialized artifact
    def forward(params, x):
        return model.apply(params, x)

    exported = jexport.export(jax.jit(forward))(params, x_spec)
    blob = exported.serialize()
    print(f"exported StableHLO artifact: {len(blob) / 1e6:.2f} MB "
          f"(platform {exported.platforms})")

    # --- serving side: rehydrate without model code and call it
    served = jexport.deserialize(blob)
    y_ref = forward(params, x)
    y_served = served.call(params, x)
    err = float(jnp.max(jnp.abs(y_ref - y_served)))
    assert err < 1e-5, err
    print(f"round-trip max |diff| = {err:.2e}")

    # --- batched-inference latency (amortized, chained to defeat async
    # dispatch elision)
    @jax.jit
    def serve_batch(p, x):
        return served.call(p, x)

    out = serve_batch(params, x)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    iters = 50
    for _ in range(iters):
        x = x + out.mean() * 1e-30  # data-dependent chain
        out = serve_batch(params, x)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"batch-8 32x32 inference: {dt * 1e3:.3f} ms/batch "
          f"({8 / dt:.0f} img/s) on {jax.devices()[0].platform}")


if __name__ == "__main__":
    main()
