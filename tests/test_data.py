"""Input pipeline tests: prefetch + batching."""

import numpy as np
import jax

from dau_convnet.data import epoch_batches, prefetch_to_device
from dau_convnet.parallel import batch_sharding, make_mesh


def test_epoch_batches_cover_all():
    x = np.arange(100).reshape(100, 1)
    y = np.arange(100)
    seen = []
    for bx, by in epoch_batches(x, y, 32, rng=np.random.default_rng(0)):
        assert bx.shape == (32, 1)
        np.testing.assert_array_equal(bx[:, 0], by)
        seen.extend(by.tolist())
    assert len(seen) == 96 and len(set(seen)) == 96  # drop_remainder


def test_prefetch_to_device_values_and_order():
    batches = [(np.full((2, 2), i, np.float32), np.array([i])) for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=2))
    assert len(out) == 5
    for i, (bx, by) in enumerate(out):
        assert isinstance(bx, jax.Array)
        assert float(bx[0, 0]) == i and int(by[0]) == i


def test_prefetch_with_sharding():
    mesh = make_mesh(jax.devices()[:8], model=1)
    sh = batch_sharding(mesh)
    batches = [(np.ones((8, 3), np.float32),) for _ in range(3)]
    out = list(prefetch_to_device(iter(batches), sharding=(sh,)))
    assert out[0][0].sharding.spec[0] == "data"


def test_prefetch_propagates_errors():
    import pytest

    def gen():
        yield (np.zeros(1),)
        raise RuntimeError("boom")

    it = prefetch_to_device(gen())
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_cifar_npz_loader(tmp_path):
    """The examples' --data-npz path consumes a standard CIFAR-10 npz
    (uint8 HWC images + integer labels) verbatim."""
    import os
    import sys

    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples.train_cifar10 import load_data

    rng = np.random.default_rng(0)
    path = str(tmp_path / "cifar.npz")
    np.savez(path,
             x_train=rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8),
             y_train=rng.integers(0, 10, (64,), dtype=np.int64),
             x_test=rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8),
             y_test=rng.integers(0, 10, (16,), dtype=np.int64))

    class Args:
        data_npz = path
        dataset = "synthetic"

    x, y, xt, yt = load_data(Args())
    assert x.shape == (64, 3, 32, 32) and x.dtype == np.float32
    assert xt.shape == (16, 3, 32, 32)
    assert y.shape == (64,) and yt.shape == (16,)
    assert float(np.abs(x).max()) <= 0.5 + 1e-6   # scaled to [-0.5, 0.5]

    # without x_test: a 90/10 split is carved from the train set
    path2 = str(tmp_path / "cifar_notest.npz")
    np.savez(path2,
             x_train=rng.integers(0, 256, (50, 32, 32, 3), dtype=np.uint8),
             y_train=rng.integers(0, 10, (50,), dtype=np.int64))

    class Args2:
        data_npz = path2
        dataset = "synthetic"

    x, y, xt, yt = load_data(Args2())
    assert len(x) == 45 and len(xt) == 5


def test_spatial_task_generator_pinned():
    """The spatial-relation generator must stay bit-stable: the recorded
    training accuracies (docs/TRAINING_RESULTS.md) and the aliasing
    analysis (examples/analyze_spatial.py) are tied to these exact bytes.
    spatial2 (distinct=True) changes ONLY blob B's width - labels and
    placements are shared with v1."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples.train_cifar10 import synthetic_spatial

    x, y, xt, yt = synthetic_spatial(n=64, n_test=16)
    assert x.shape == (64, 3, 32, 32) and xt.shape == (16, 3, 32, 32)
    np.testing.assert_allclose(np.float64(x).sum(), -475.8363665071174,
                               rtol=1e-9)
    assert int(y.sum()) == 296
    np.testing.assert_allclose(float(x[0, 0, 16, 16]), -0.7124876976013184,
                               rtol=1e-6)

    x2, y2, _, _ = synthetic_spatial(n=64, n_test=16, distinct=True)
    assert np.array_equal(y2, y)          # same labels/placements
    assert not np.array_equal(x2, x)      # blob B width differs
