"""Checkpoint save/restore roundtrip (orbax on the DAU param pytree)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dau_convnet.nn import DAUConv2d

orbax = pytest.importorskip("orbax.checkpoint")

from dau_convnet.utils.checkpoint import (  # noqa: E402
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


def test_roundtrip(tmp_path):
    op = DAUConv2d(filters=4, dau_units=(2, 1), max_kernel_size=9)
    x = jnp.ones((1, 3, 8, 8), jnp.float32)
    params = op.init(jax.random.PRNGKey(0), x)

    ckpt_dir = str(tmp_path / "ckpt")
    save_checkpoint(ckpt_dir, step=3, state=params)
    assert latest_step(ckpt_dir) == 3

    restored = restore_checkpoint(ckpt_dir, params)
    for k in ("weights", "mu1", "mu2", "sigma", "bias"):
        np.testing.assert_array_equal(
            np.asarray(restored["params"][k]),
            np.asarray(params["params"][k]))

    # restored params produce identical outputs
    y0 = op.apply(params, x)
    y1 = op.apply(restored, x)
    np.testing.assert_array_equal(np.asarray(y0), np.asarray(y1))


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), {"a": jnp.ones(1)})
