"""Sharded training-step builders (pjit-style, XLA-inserted collectives).

Replaces nothing in the reference (which trains through TF sessions on one
GPU); this is the training harness for the DAU model zoo: one jitted train
step whose inputs/outputs carry NamedShardings, so XLA partitions compute
over the mesh and inserts psum/all-gather (NCCL on GPUs).

`model` is anything with `init(rng, x) -> {"params": ...}` and
`apply(variables, x[, mutable=...])`: the flax-free `models.AlexNetDAU`
or a flax module.
"""

from __future__ import annotations

import typing as tp

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import batch_sharding, param_shardings

__all__ = ["TrainState", "make_train_step", "init_sharded"]


class TrainState(tp.NamedTuple):
    params: tp.Any
    opt_state: tp.Any
    step: jax.Array
    extra_vars: tp.Any = ()  # mutable collections (e.g. batch_stats)


def softmax_xent(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


def init_sharded(model, tx, mesh: Mesh, sample_input, rng=None,
                 model_axis: str = "model"):
    """Initialize model params + optimizer state with mesh shardings applied.

    Returns (state, state_shardings).
    """
    rng = jax.random.PRNGKey(0) if rng is None else rng
    variables = jax.eval_shape(model.init, rng, sample_input)
    var_sh = param_shardings(variables, mesh, model_axis)

    init_fn = jax.jit(model.init, out_shardings=var_sh)
    variables = init_fn(rng, jax.device_put(sample_input, batch_sharding(mesh)))

    params = variables["params"]
    p_sh = var_sh["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    extra_sh = {k: v for k, v in var_sh.items() if k != "params"}
    opt_state = tx.init(params)
    # optimizer slots mirror param shardings; scalars replicated
    opt_sh = _opt_shardings(opt_state, params, p_sh, mesh)
    state = TrainState(params=params, opt_state=opt_state,
                       step=jnp.zeros((), jnp.int32), extra_vars=extra)
    sh = TrainState(params=p_sh, opt_state=opt_sh,
                    step=NamedSharding(mesh, P()), extra_vars=extra_sh)
    state = jax.device_put(state, sh)
    return state, sh


def _opt_shardings(opt_state, params, p_sh, mesh):
    """Shard optimizer slots like their matching params, keyed by tree path.

    Optax "params-like" slots (momentum/trace/mu/nu, ...) are whole subtrees
    with the params' exact tree structure; each such subtree mirrors `p_sh`
    leaf-for-leaf, so two same-shaped params with different shardings keep
    their own (a (shape, dtype) map would silently alias them). Everything
    else (step counts, EmptyState, scalar hyperparams) is replicated.
    """
    p_def = jax.tree_util.tree_structure(params)
    p_shapes = [getattr(l, "shape", None)
                for l in jax.tree_util.tree_leaves(params)]
    repl = NamedSharding(mesh, P())

    def is_params_like(x):
        try:
            if jax.tree_util.tree_structure(x) != p_def:
                return False
        except Exception:
            return False
        leaves = jax.tree_util.tree_leaves(x)
        return all(getattr(a, "shape", None) == s
                   for a, s in zip(leaves, p_shapes))

    return jax.tree_util.tree_map(
        lambda sub: p_sh if is_params_like(sub) else
        jax.tree_util.tree_map(lambda _: repl, sub),
        opt_state, is_leaf=is_params_like)


def make_train_step(model, tx, mesh: Mesh, state_shardings,
                    loss_fn=softmax_xent, donate: bool = True):
    """Build a jitted, mesh-sharded train step.

    step(state, x, labels) -> (state, loss); x is sharded over the 'data'
    axis, loss replicated. With tensor parallelism on, the F-axis param
    shardings flow through the conv and XLA inserts the collectives.
    Mutable collections (e.g. BatchNorm batch_stats) ride in
    `state.extra_vars` and are threaded through `mutable=` automatically;
    under data parallelism their per-shard values stay shard-local (like
    per-replica batch norm), which is the common efficient choice.
    """
    data_sh = batch_sharding(mesh)
    repl = NamedSharding(mesh, P())

    def step(state: TrainState, x, labels):
        mutable = list(state.extra_vars) if state.extra_vars else False

        def loss_of(params):
            variables = {"params": params, **dict(state.extra_vars or {})}
            if mutable:
                logits, updates = model.apply(variables, x, mutable=mutable)
                return loss_fn(logits, labels), updates
            return loss_fn(model.apply(variables, x), labels), {}

        (loss, new_extra), grads = jax.value_and_grad(
            loss_of, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        extra = new_extra if mutable else state.extra_vars
        return TrainState(params, opt_state, state.step + 1, extra), loss

    jitted = jax.jit(
        step,
        in_shardings=(state_shardings, data_sh, data_sh),
        out_shardings=(state_shardings, repl),
        donate_argnums=(0,) if donate else (),
    )

    return jitted
