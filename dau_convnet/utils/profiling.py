"""Profiling/tracing helpers.

The reference's tracing is compile-time `#define PROFILE_CUDA` blocks that
sync + clock() each sub-kernel (dau_conv_forward_core.hpp:2506-2562). The
JAX equivalent is jax.profiler traces (viewable in Perfetto /
TensorBoard) plus honest wall-clock timing that defeats async dispatch.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "device_time"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed block into `logdir`."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_time(fn, *args, iters: int = 10) -> float:
    """Best-effort per-call wall time of a jitted fn (blocks on results).

    For rigorous numbers use bench.py's chained-scan methodology: repeated
    identical dispatches can be elided or overlapped by async runtimes.
    """
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best
