"""Host-side input pipeline: double-buffered device prefetch.

The reference has no data loader (training lived in external repos); this
is the piece a production trainer needs: overlap host batch
preparation and host->device transfer with device compute, so the training
step never waits on input. Pure Python threading + jax.device_put - the
device transfer of batch k+1 rides under the compute of batch k.
"""

from __future__ import annotations

import queue
import threading
import typing as tp

import jax

__all__ = ["prefetch_to_device", "epoch_batches"]


def prefetch_to_device(batch_iter: tp.Iterator, size: int = 2,
                       sharding=None) -> tp.Iterator:
    """Wrap a host batch iterator with an N-deep device-transfer pipeline.

    Args:
      batch_iter: yields pytrees of numpy/host arrays.
      size: prefetch depth (2 = double buffering).
      sharding: optional jax.sharding.Sharding (or pytree of them) applied
        by device_put - feeds multi-chip meshes directly.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []

    def producer():
        try:
            for batch in batch_iter:
                q.put(jax.device_put(batch, sharding))
        except Exception as e:  # noqa: BLE001 - surface in consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def epoch_batches(x, y, batch_size: int, *, rng=None, drop_remainder=True):
    """Shuffled in-memory batch iterator over (x, y) numpy arrays."""
    import numpy as np

    n = len(x)
    order = (np.random.default_rng() if rng is None else rng).permutation(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        idx = order[i:i + batch_size]
        yield x[idx], y[idx]
