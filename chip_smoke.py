"""Smoke test of the whole system on one NVIDIA GPU.

Runs, in one process and in order:

1. device - what JAX sees, and the card's name and power limit from
   nvidia-smi; anything but a GPU stops the run (there is no CPU fallback);
2. layers - `dau_conv2d_op` forward plus the full VJP at the four
   AlexNet-DAU layer widths (conv2-conv5, G=2, k=9, N=2), in the oracle
   mode (f32, precision 'highest', xla engine; the fourier engine is held
   to the same bound in f32 'highest') and the production mode (bf16,
   precision 'default', fourier engine), each compared with the float64
   numpy oracle (`ops/reference.py`) on a seeded channel subset;
3. train - the full-width AlexNet-DAU default model (0.74M DAU units,
   N=32, 3x227x227, bf16): one jitted SGD step, compiled, then 5 steps on
   a fixed seeded batch (finite, falling loss, mu1 moves) and a timed
   window after them;
4. serve - the phi-cached serving forward (`AlexNetDAU.phi_tables`, i.e.
   `ops.precompute_phi` + `ops.dau_conv2d_infer`) against the plain
   forward.

The last line is the JSON object
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Any failure exits non-zero before it.

`--four` runs only the multi-card path instead: `parallel.make_train_step`
over 4 GPUs as data 4 and as data 2 x model 2, each compared with the
one-card step on the same global batch, in float64 for both engines.

    python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from dau_convnet.utils.device import (card_name_and_power_limit,
                                      configure_compile_cache,
                                      describe_devices, require_gpu)

# (name, S, F, H=W) of the AlexNet-DAU layers at 227x227 input
LAYERS = (("conv2", 96, 256, 27), ("conv3", 256, 384, 13),
          ("conv4", 384, 384, 13), ("conv5", 384, 256, 13))
SIGMA = 0.5
# f32 'highest' against the float64 oracle, normalized max error. TF32
# (10 mantissa bits) lands near 1e-3, so this bound fails any f32 product
# that silently dropped to it.
ORACLE_TOL = 2e-5
# bf16 production mode: bounded in absolute terms and within 4x of the xla
# engine's own bf16 error on the same inputs (the floor keeps the rule
# meaningful where the xla error is tiny), the rule of
# tests/test_fourier_precision.py.
BF16_ABS_TOL = 0.1
BF16_REL_FACTOR = 4.0
BF16_FLOOR = 1e-3
# serving vs plain forward, both bf16: the same table build and apply,
# compiled as two programs whose autotuned kernels may sum in another
# order; bf16 rounding differences propagated through the net stay near
# 1e-2 of the logit scale, a wrong table gives O(1).
SERVE_TOL = 5e-2
# sharded vs one-card step, in float64: the same sums in another order
# across devices, so both agree to f64 roundoff (~1e-15); a missing or
# doubled cross-device reduction is off by >= 50%, and any part of the
# sharded program that ran below f64 by >= ~1e-7. In f32 the comparison
# says little: two correct f32 programs that round differently flip a few
# of the full-width net's max-pool or ReLU choices, and each flip moves
# the mu update of the layer before it by up to ~1e-2 of the leaf's
# largest entry (measured against a float64 step; see PERF.md).
FOUR_LOSS_TOL = 1e-12
FOUR_UPDATE_TOL = 1e-9
SUBSET = 8          # channels per side the oracle evaluates
TRAIN_LR = 1e-3


def say(msg):
    print(msg, flush=True)


def rel_err(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---- 1. device ------------------------------------------------------------

def phase_device():
    """Print the devices; return them if they are GPUs (RuntimeError
    otherwise)."""
    devices = jax.devices()
    info = describe_devices(devices)
    say(f"devices: {devices}")
    say(f"platform={info['platform']} kind={info['kind']!r} "
        f"count={info['count']}")
    require_gpu()
    for line in card_name_and_power_limit().splitlines():
        say(f"card: {line}")
    return devices


# ---- 2. layers -------------------------------------------------------------

def layer_case(seed, n, s, f, hw, g=2):
    rng = np.random.default_rng(seed)
    x = rng.random((n, s, hw, hw)).astype(np.float32)
    w = (rng.standard_normal((1, s, g, f)) * 0.1).astype(np.float32)
    mu1 = rng.uniform(-3.9, 3.9, (1, s, g, f)).astype(np.float32)
    mu2 = rng.uniform(-3.9, 3.9, (1, s, g, f)).astype(np.float32)
    err = rng.standard_normal((n, f, hw, hw)).astype(np.float32)
    s_idx = np.sort(rng.choice(s, min(SUBSET, s), replace=False))
    f_idx = np.sort(rng.choice(f, min(SUBSET, f), replace=False))
    return (x, w, mu1, mu2, err), (s_idx, f_idx)


def device_fwd_bwd(precision, dtype, engine, case):
    """(resolved engine, [y, dx, dw, dmu1, dmu2]) of the op on the default
    device."""
    from dau_convnet.ops import DAUConvSettings, dau_conv2d_op

    cfg = DAUConvSettings(kernel_size=9, precision=precision, engine=engine,
                          compute_sigma_grad=False)
    x, w, mu1, mu2, err = (jnp.asarray(a, dtype) for a in case)
    sig = jnp.full((1,), SIGMA, dtype)

    @jax.jit
    def run(x, w, mu1, mu2, err):
        y, vjp = jax.vjp(lambda *a: dau_conv2d_op(cfg, *a, sig),
                         x, w, mu1, mu2)
        return (y, *vjp(err))

    return cfg.engine, [np.asarray(o, np.float64)
                        for o in run(x, w, mu1, mu2, err)]


def oracle_subset(case, idx):
    """The float64 oracle's y on output channels f_idx, dx on input
    channels s_idx and the unit gradients on (s_idx, f_idx). Each is exact
    for its subset: y[:, f] depends only on the units of f, dx[:, s] only
    on those of s."""
    from dau_convnet.ops import reference as ref

    x, w, mu1, mu2, err = case
    s_idx, f_idx = idx
    sig = [SIGMA]
    y = ref.forward(x, w[..., f_idx], mu1[..., f_idx], mu2[..., f_idx], sig)
    ws, m1, m2 = (a[:, s_idx] for a in (w, mu1, mu2))
    dx = ref.forward(err, np.swapaxes(ws, 1, 3), np.swapaxes(-m1, 1, 3),
                     np.swapaxes(-m2, 1, 3), sig, do_error_backprop=True)
    _, dw, dmu1, dmu2, _ = ref.backward(
        x[:, s_idx], err[:, f_idx], ws[..., f_idx], m1[..., f_idx],
        m2[..., f_idx], sig)
    return [y, dx, dw, dmu1, dmu2]


def subset_of(outs, idx):
    s_idx, f_idx = idx
    y, dx, dw, dmu1, dmu2 = outs
    return [y[:, f_idx], dx[:, s_idx]] + [g[:, s_idx][..., f_idx]
                                           for g in (dw, dmu1, dmu2)]


NAMES = ("y", "dx", "dw", "dmu1", "dmu2")


def check_layer(name, n, s, f, hw, seed=0):
    """Both modes of one layer shape against the oracle; returns the
    errors, raises AssertionError on a failed bound."""
    case, idx = layer_case(seed, n, s, f, hw)
    t0 = time.perf_counter()
    ref = oracle_subset(case, idx)
    t_oracle = time.perf_counter() - t0
    eng_b, oracle_mode = device_fwd_bwd("highest", jnp.float32, "auto", case)
    _, fourier_f32 = device_fwd_bwd("highest", jnp.float32, "fourier", case)
    eng_a, prod = device_fwd_bwd("default", jnp.bfloat16, "auto", case)
    _, xla_bf16 = device_fwd_bwd("default", jnp.bfloat16, "xla", case)
    assert (eng_b, eng_a) == ("xla", "fourier"), (eng_b, eng_a)
    say(f"layer {name}: S={s} F={f} {hw}x{hw} N={n} G=2 k=9; oracle "
        f"ops/reference.py float64 on {len(idx[0])} input x {len(idx[1])} "
        f"output channels ({t_oracle:.1f} s)")
    errs = {}
    failed = []
    for q, r, b, bf, a, xb in zip(NAMES, ref, subset_of(oracle_mode, idx),
                                  subset_of(fourier_f32, idx),
                                  subset_of(prod, idx),
                                  subset_of(xla_bf16, idx)):
        e_b, e_bf = rel_err(b, r), rel_err(bf, r)
        e_a, e_x = rel_err(a, r), rel_err(xb, r)
        bound_a = min(BF16_ABS_TOL, max(BF16_REL_FACTOR * e_x, BF16_FLOOR))
        ok_b = e_b <= ORACLE_TOL and e_bf <= ORACLE_TOL
        ok_a = e_a <= bound_a
        say(f"  {q:5s} (b) f32/highest/{eng_b} {e_b:.3e}, f32/highest/fourier"
            f" {e_bf:.3e} <= {ORACLE_TOL:g} {'ok' if ok_b else 'FAIL'} | "
            f"(a) bf16/default/{eng_a} {e_a:.3e} <= {bound_a:.3e} (xla bf16 "
            f"{e_x:.3e}) {'ok' if ok_a else 'FAIL'}")
        errs[q] = (e_b, e_bf, e_a, e_x)
        if not (ok_b and ok_a):
            failed.append(q)
    assert not failed, f"layer {name}: {failed} out of tolerance"
    return errs


def phase_layers(n=2, layers=LAYERS):
    return {name: check_layer(name, n, s, f, hw)
            for name, s, f, hw in layers}


# ---- 3. train --------------------------------------------------------------

def seeded_batch(n, image_hw, dtype, seed=0, classes=1000):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.random((n, 3, image_hw, image_hw)), dtype)
    labels = jnp.asarray(rng.integers(0, classes, (n,)))
    return x, labels


def xent(logits, labels):
    import optax
    return optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), labels).mean()


def phase_train(n=32, image_hw=227, steps=5, timed=10):
    """Full-width AlexNet-DAU default, bf16: compile, `steps` checked steps,
    then `timed` steps on the clock."""
    import optax

    from dau_convnet.models import AlexNetDAU

    model = AlexNetDAU(variant="default", dtype=jnp.bfloat16)
    x, labels = seeded_batch(n, image_hw, jnp.bfloat16)
    tx = optax.sgd(TRAIN_LR)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)["params"]
    opt_state = tx.init(params)
    mu1_0 = np.asarray(params["dau_conv3"]["mu1"], np.float32)

    def step(params, opt_state, x, labels):
        loss, grads = jax.value_and_grad(
            lambda p: xent(model.apply({"params": p}, x), labels))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    t0 = time.perf_counter()
    compiled = jax.jit(step, donate_argnums=(0, 1)).lower(
        params, opt_state, x, labels).compile()
    compile_s = time.perf_counter() - t0
    say(f"train: AlexNet-DAU default, {model.num_dau_units()} DAU units, "
        f"N={n} 3x{image_hw}x{image_hw} bf16; compile {compile_s:.2f} s "
        "(set-up)")
    say(f"train: memory_analysis {compiled.memory_analysis()}")

    losses = []
    for _ in range(steps):
        params, opt_state, loss = compiled(params, opt_state, x, labels)
        losses.append(float(loss))
    say(f"train: losses {losses}")
    assert all(np.isfinite(losses)), "non-finite loss"
    assert losses[-1] < losses[0], "loss did not fall"
    moved = float(np.abs(np.asarray(params["dau_conv3"]["mu1"], np.float32)
                         - mu1_0).max())
    assert moved > 0.0, "mu1 did not move"
    say(f"train: max |mu1 change| in dau_conv3 after {steps} steps {moved:.4g}")

    jax.block_until_ready(params)
    t0 = time.perf_counter()
    for _ in range(timed):
        params, opt_state, loss = compiled(params, opt_state, x, labels)
    jax.block_until_ready((params, loss))
    step_s = (time.perf_counter() - t0) / timed
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    say(f"train: steady step {step_s * 1e3:.3f} ms over {timed} steps "
        f"({n / step_s:.1f} img/s); peak_bytes_in_use {peak}")
    return {"compile_s": compile_s, "step_s": step_s, "losses": losses,
            "peak_bytes_in_use": peak}


# ---- 4. serve --------------------------------------------------------------

def phase_serve(n=8, image_hw=227):
    """Phi-cached serving forward vs the plain forward, bf16."""
    from dau_convnet.models import AlexNetDAU

    model = AlexNetDAU(variant="default", dtype=jnp.bfloat16)
    x, _ = seeded_batch(n, image_hw, jnp.bfloat16, seed=1)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), x)
    plain = jax.jit(model.apply)(variables, x)
    tables = jax.jit(lambda v: model.phi_tables(v, (image_hw, image_hw)))(
        variables)
    served = jax.jit(lambda v, t, x: model.apply(v, x, phi_tables=t))(
        variables, tables, x)
    err = rel_err(served, plain)
    say(f"serve: phi-cached vs plain forward, N={n} bf16 logits, normalized "
        f"max error {err:.3e} <= {SERVE_TOL:g} "
        f"{'ok' if err <= SERVE_TOL else 'FAIL'}")
    assert np.all(np.isfinite(np.asarray(served, np.float32)))
    assert err <= SERVE_TOL, f"serving forward off by {err:.3e}"
    return err


# ---- --four ----------------------------------------------------------------

def _check_batch_placement(xs, mesh, n):
    """Each device holds its own share of the batch, not a copy of all."""
    data = mesh.shape["data"]
    shards = xs.addressable_shards
    assert {sh.device for sh in shards} == set(mesh.devices.flat), shards
    for sh in shards:
        assert sh.data.shape[0] == n // data, (sh.device, sh.data.shape)
        assert sh.data.devices() == {sh.device}
    starts = {sh.index[0].start or 0 for sh in shards}
    assert len(starts) == data, starts


def _update(new_state, state0):
    return jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                  new_state.params, state0.params)


def _worst_leaf(upd, ref_upd):
    """(leaf path, normalized max error) of the leaf that differs most."""
    errs = {jax.tree_util.keystr(k): rel_err(a, b)
            for (k, a), b in zip(jax.tree_util.tree_leaves_with_path(upd),
                                 jax.tree_util.tree_leaves(ref_upd))}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def phase_four(devices, n=32, image_hw=227):
    """make_train_step over 4 devices, data 4 and data 2 x model 2, each
    against the one-device step on the same global batch and the same
    float64 parameters, for both engines (float64 throughout, SGD with
    learning rate 1, so the update is minus the gradient)."""
    import optax

    from dau_convnet.models import AlexNetDAU
    from dau_convnet.parallel import (batch_sharding, init_sharded,
                                      make_mesh, make_train_step)

    devices = list(devices)[:4]
    assert len(devices) == 4, f"--four needs 4 devices, found {len(devices)}"
    tx = optax.sgd(1.0)
    results, failed = {}, []
    with jax.enable_x64(True):
        x, labels = seeded_batch(n, image_hw, jnp.float64)

        def one_step(model, mesh, state0=None):
            state, sh = init_sharded(model, tx, mesh, x)
            if state0 is None:
                state0 = jax.tree_util.tree_map(
                    lambda a: a.astype(jnp.float64)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a, state)
            state = jax.device_put(state0, sh)
            step = make_train_step(model, tx, mesh, sh, donate=False)
            xs = jax.device_put(x, batch_sharding(mesh))
            ys = jax.device_put(labels, batch_sharding(mesh))
            _check_batch_placement(xs, mesh, n)
            t0 = time.perf_counter()
            new_state, loss = step(state, xs, ys)
            jax.block_until_ready(loss)
            return (jax.device_get(state), jax.device_get(new_state),
                    float(loss), time.perf_counter() - t0)

        for engine in ("xla", "fourier"):
            model = AlexNetDAU(variant="default", dtype=jnp.float64,
                               engine=engine)
            ref_mesh = make_mesh(devices[:1], data=1, model=1)
            state0, ref_state, ref_loss, ref_s = one_step(model, ref_mesh)
            ref_upd = _update(ref_state, state0)
            say(f"four: {engine} f64 one-device step (compile + run "
                f"{ref_s:.1f} s), loss {ref_loss!r}")
            for name, model_par in (("dp4", 1), ("dp2xtp2", 2)):
                mesh = make_mesh(devices, model=model_par)
                _, st, loss, secs = one_step(model, mesh, state0)
                loss_err = abs(loss - ref_loss) / abs(ref_loss)
                worst, upd_err = _worst_leaf(_update(st, state0), ref_upd)
                ok = loss_err <= FOUR_LOSS_TOL and upd_err <= FOUR_UPDATE_TOL
                say(f"four: {engine} {name} mesh={dict(mesh.shape)} (compile "
                    f"+ run {secs:.1f} s) loss {loss!r} rel err "
                    f"{loss_err:.2e} <= {FOUR_LOSS_TOL:g}; max normalized "
                    f"update error {upd_err:.2e} ({worst}) <= "
                    f"{FOUR_UPDATE_TOL:g} {'ok' if ok else 'FAIL'}")
                results[f"{engine}_{name}"] = (loss_err, upd_err)
                if not ok:
                    failed.append(f"{engine} {name}")
    assert not failed, f"{failed} disagree with the one-device step"
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU data/tensor-parallel check")
    args = ap.parse_args(argv)
    configure_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    try:
        devices = phase_device()
    except RuntimeError as exc:
        say(f"device: {exc}")
        return 1
    if args.four:
        phase_four(devices)
        count = 4
    else:
        phase_layers()
        phase_train()
        phase_serve()
        count = len(devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
