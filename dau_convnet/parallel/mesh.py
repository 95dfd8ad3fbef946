"""Device-mesh helpers for data- and tensor-parallel DAU training.

The reference has no distributed layer at all (SURVEY.md section 2.3: no
NCCL/MPI/Gloo anywhere in the tree; its only concurrency is 4 intra-GPU CUDA
streams). Here scaling is first-class: a `jax.sharding.Mesh` over the
devices with named axes, parameters/batch annotated with `NamedSharding`,
and XLA inserting the all-reduces (NCCL on GPUs). These helpers encode the DAU-specific sharding
rules:

- data parallel: batch dim of the NCHW input over the 'data' axis; gradient
  all-reduce is an XLA-generated psum.
- tensor parallel: the F (out-channel) axis of every DAU parameter
  [1, S, G, F] (and conv/dense out-features) over the 'model' axis. The
  aggregation conv is channel-parallel: each shard computes its F-slice of
  the output with zero communication in fwd; bwd input-grad needs one psum
  over 'model' (inserted by XLA from the shardings).
"""

from __future__ import annotations

import typing as tp

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "dau_param_spec", "param_shardings",
           "batch_sharding", "P"]


def make_mesh(devices=None, *, data: int = -1, model: int = 1,
              axis_names=("data", "model")) -> Mesh:
    """Build a (data x model) mesh. `data=-1` absorbs remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, axis_names)


def dau_param_spec(path: tp.Tuple[str, ...], value, model_axis: str = "model"):
    """PartitionSpec for one parameter leaf by name/shape.

    DAU params [1, S, G, F] and dense kernels [.., F] shard their trailing
    (out-feature) axis over the model axis; scalars/sigma/bias stay
    replicated if too small to shard.
    """
    name = path[-1] if path else ""
    shape = getattr(value, "shape", ())
    if name in ("weights", "mu1", "mu2") and len(shape) == 4:
        return P(None, None, None, model_axis)
    if name == "kernel" and len(shape) >= 2:
        return P(*([None] * (len(shape) - 1)), model_axis)
    if name == "bias" and len(shape) == 1:
        return P(model_axis)
    return P()


def param_shardings(params, mesh: Mesh, model_axis: str = "model"):
    """NamedSharding pytree for a flax param tree using `dau_param_spec`.

    If the model axis has size 1 (pure DP) everything is replicated.
    """
    tp_on = mesh.shape.get(model_axis, 1) > 1

    def leaf(path, v):
        spec = dau_param_spec(tuple(str(getattr(p, "key", p)) for p in path), v,
                              model_axis) if tp_on else P()
        # only shard if the axis divides evenly; replicate otherwise
        if tp_on and any(spec):
            for dim, ax in enumerate(spec):
                if ax is not None and v.shape[dim] % mesh.shape[ax] != 0:
                    spec = P()
                    break
        return NamedSharding(mesh, spec)

    return jax.tree_util.tree_map_with_path(leaf, params)


def batch_sharding(mesh: Mesh, data_axis: str = "data"):
    """Sharding for NCHW (or any batch-major) arrays: batch over data axis."""
    return NamedSharding(mesh, P(data_axis))


def spatial_sharding(mesh: Mesh, axis: str = "data"):
    """Shard the H dimension of NCHW inputs across devices.

    Cross-chip version of the reference's intra-GPU spatial patch
    decomposition (images split into patches with a MAX_OFFSET halo,
    dau_conv_forward_core.hpp:1669-1719): both the blur and the aggregation
    lower to XLA convolutions, for which the SPMD partitioner inserts the
    halo exchanges automatically - no manual ghost cells. Useful
    for images too large for one device's memory.
    """
    return NamedSharding(mesh, P(None, None, axis, None))
