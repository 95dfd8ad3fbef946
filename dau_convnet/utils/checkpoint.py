"""Checkpoint/restore for DAU model state (Orbax).

The reference has no checkpoint subsystem (TF variables checkpoint through
standard TF savers; pretrained Caffe models ship as gists, reference
README.md:32-35). Here: Orbax on the param pytree
{weights: [1,S,G,F], mu1, mu2, sigma: [1], bias: [F]} - works transparently
with sharded (multi-device) state - plus a dependency-free npz format.

Orbax is optional (the `nn` extra); the Orbax functions raise an
ImportError naming the extra when it is missing.
"""

from __future__ import annotations

import os
import typing as tp

import jax

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "save_params_npz", "load_params_npz", "restore_params_npz"]


def _flat_with_keys(prefix: str, tree: tp.Any):
    """[(npz key, leaf)] of a pytree, keys '/'-joined from the tree name."""
    out = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        # DictKey has .key, SequenceKey .idx, GetAttrKey .name - cover
        # non-dict containers instead of assuming dict-only pytrees
        names = [str(getattr(k, "key", getattr(k, "idx",
                                               getattr(k, "name", k))))
                 for k in kp]
        out.append(("/".join([prefix] + names), leaf))
    return out


def save_params_npz(path: str, **trees: tp.Any) -> None:
    """Flatten named pytrees into one portable npz (keys are '/'-joined
    paths rooted at the tree name, e.g. 'params/dau_conv1/mu1').

    The portable-artifact analogue of the reference's gist-distributed
    pretrained models (reference README.md:32-35): a plain npz that
    `load_params_npz` + `set_dau_variables_manually` can re-install into
    any freshly init'ed model."""
    import numpy as np
    flat = {}
    for prefix, tree in trees.items():
        for key, leaf in _flat_with_keys(prefix, tree):
            flat[key] = np.asarray(leaf)
    np.savez(path, **flat)


def restore_params_npz(path: str, **like: tp.Any) -> tp.Dict[str, tp.Any]:
    """Read named pytrees written by `save_params_npz` back into the
    structure of the given examples (any pytree: optimizer states
    included). Returns {name: tree} with host (numpy) leaves."""
    import numpy as np
    out = {}
    with np.load(path) as d:
        for name, tree in like.items():
            keys = [key for key, _ in _flat_with_keys(name, tree)]
            out[name] = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(tree), [d[k] for k in keys])
    return out


def load_params_npz(path: str) -> tp.Dict[str, tp.Any]:
    """Inverse of `save_params_npz`: returns {tree_name: nested dict}.

    Non-dict containers saved by `save_params_npz` come back as dicts keyed
    by their stringified index/attr name (the npz format is path-flat)."""
    import numpy as np
    trees: tp.Dict[str, tp.Any] = {}
    with np.load(path) as d:
        for key in d.files:
            parts = key.split("/")
            if len(parts) == 1:
                # the named tree was a single bare leaf (no path under the
                # tree name): return the array itself, not {name: {name: a}}
                trees[parts[0]] = d[key]
                continue
            node = trees.setdefault(parts[0], {})
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = d[key]
    return trees


def _ocp():
    try:
        import orbax.checkpoint as ocp
    except ImportError as exc:
        raise ImportError(
            "Orbax checkpointing needs the 'nn' extra: "
            "pip install 'dau-convnet[nn]' (orbax-checkpoint)") from exc
    return ocp


def _manager(directory: str, max_to_keep: int = 3):
    ocp = _ocp()
    return ocp.CheckpointManager(
        directory,
        options=ocp.CheckpointManagerOptions(max_to_keep=max_to_keep),
    )


def save_checkpoint(directory: str, step: int, state: tp.Any,
                    max_to_keep: int = 3) -> None:
    """Save a pytree (params / TrainState) at `step` under `directory`."""
    ocp = _ocp()
    os.makedirs(directory, exist_ok=True)
    with _manager(directory, max_to_keep) as mgr:
        mgr.save(step, args=ocp.args.StandardSave(state))
        mgr.wait_until_finished()


def restore_checkpoint(directory: str, state_like: tp.Any,
                       step: tp.Optional[int] = None) -> tp.Any:
    """Restore the pytree saved at `step` (default: latest). `state_like`
    provides structure/shardings (abstract values are fine)."""
    ocp = _ocp()
    with _manager(directory) as mgr:
        step = mgr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        target = jax.tree_util.tree_map(ocp.utils.to_shape_dtype_struct, state_like)
        return mgr.restore(step, args=ocp.args.StandardRestore(target))


def latest_step(directory: str) -> tp.Optional[int]:
    with _manager(directory) as mgr:
        return mgr.latest_step()
