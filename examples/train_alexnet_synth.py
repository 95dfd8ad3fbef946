"""Train AlexNet-DAU end-to-end on the GPU for >=1k steps (synthetic data).

The closest feasible analogue of the reference's trained-network evidence
(reference README.md:29-35 distributes Caffe-trained AlexNet-DAU variants;
ImageNet itself is not available in this environment): memorize a fixed
synthetic dataset with the full flagship net at production shapes
(N=32, 3x227x227, bf16, fourier engine), demonstrating

- loss descent over >=1000 optimizer steps,
- stable step time (per-chunk wall clock, chained on-device via lax.scan),
- checkpoint + RESUME mid-run through utils/checkpoint.py (npz),
- params staying within reference bounds via nn.project_dau_params
  (the functional form of base_dau_conv_layer.cu:33-49's storage clip).

Also the long-run stability check (the role of the reference's
test_DAUConvMemtest, dau_conv_test.py:635-682): every loss must be finite.

Needs only JAX, numpy and optax (no flax, no Orbax).

Usage:  python examples/train_alexnet_synth.py --steps 1000
Writes a JSON record (loss curve, chunk times, resume check) to
--out (default build/alexnet_synth_train.json in the checkout).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp
import optax

from dau_convnet.models import AlexNetDAU
from dau_convnet.nn import project_dau_params
from dau_convnet.utils import checkpoint as ckpt
from dau_convnet.utils.device import (card_name_and_power_limit,
                                      configure_compile_cache,
                                      describe_devices)
from dau_convnet.utils.tiers import max_offset_in_tree

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=50,
                    help="steps per on-device lax.scan chunk (host logging "
                         "and checkpointing happen between chunks)")
    ap.add_argument("--variant", default="small",
                    choices=["small", "default", "large"])
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--num-batches", type=int, default=8,
                    help="fixed synthetic batches to memorize")
    ap.add_argument("--classes", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(
        CHECKOUT, "build", "alexnet_synth_ckpt.npz"))
    ap.add_argument("--out", default=os.path.join(
        CHECKOUT, "build", "alexnet_synth_train.json"))
    args = ap.parse_args()
    configure_compile_cache(CHECKOUT)
    for path in (args.ckpt, args.out):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    dtype = jnp.bfloat16
    rng = np.random.default_rng(0)
    # fixed dataset: labels are random -> the only way loss descends is the
    # net actually learning (memorizing) through the DAU layers
    data = jnp.asarray(rng.random((args.num_batches, args.N, 3, 227, 227)),
                       dtype)
    labels = jnp.asarray(
        rng.integers(0, args.classes, (args.num_batches, args.N)))

    net = AlexNetDAU(variant=args.variant, num_classes=args.classes,
                     dtype=dtype, engine="fourier")
    params = jax.jit(net.init)(jax.random.PRNGKey(0), data[0])
    print(f"AlexNet-DAU-{args.variant}: {net.num_dau_units()} DAU units, "
          f"{sum(x.size for x in jax.tree_util.tree_leaves(params))} params",
          flush=True)

    # global-norm clipping guards the late-memorization regime (observed:
    # an unclipped run memorized to loss ~0.003 by step 500, then spiked to
    # ~3.9 at step ~880 - an Adam update blow-up at near-zero loss)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(args.lr))
    opt_state = tx.init(params)

    def one_step(carry, i):
        params, opt_state = carry
        x = jax.lax.dynamic_index_in_dim(data, i % args.num_batches, 0,
                                         keepdims=False)
        y = jax.lax.dynamic_index_in_dim(labels, i % args.num_batches, 0,
                                         keepdims=False)

        def loss_fn(p):
            logits = net.apply(p, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        # reference bounds guard per step (base_dau_conv_layer.cu:33-49)
        params = project_dau_params(params, kernel_size=net.max_kernel_size)
        return (params, opt_state), loss

    @jax.jit
    def run_chunk(carry, start):
        return jax.lax.scan(one_step, carry,
                            start + jnp.arange(args.chunk))

    carry = (params, opt_state)
    losses: list[float] = []
    chunk_ms: list[float] = []
    resume_delta = None
    restore_transfer_s = None

    step = 0
    while step < args.steps:
        t0 = time.perf_counter()
        carry, chunk_losses = run_chunk(carry, jnp.asarray(step))
        chunk_losses = np.asarray(
            jax.block_until_ready(chunk_losses), np.float32)
        dt = time.perf_counter() - t0
        step += args.chunk
        losses.extend(float(l) for l in chunk_losses)
        chunk_ms.append(dt * 1e3 / args.chunk)
        live = max_offset_in_tree(carry[0])
        print(f"step {step:5d}  loss {chunk_losses[-1]:.4f}  "
              f"{dt * 1e3 / args.chunk:7.2f} ms/step  max|mu| {live:.3f}",
              flush=True)
        assert np.all(np.isfinite(chunk_losses)), "non-finite loss"

        # mid-run: checkpoint, throw the live state away, RESTORE, continue
        if resume_delta is None and step >= args.steps // 2:
            ckpt.save_params_npz(args.ckpt, state=carry)
            apply = jax.jit(lambda p: net.apply(p, data[0]))
            probe = apply(carry[0])
            restored = ckpt.restore_params_npz(args.ckpt, state=carry)
            # restored leaves live on host; push them to the device NOW and
            # time it, so the transfer doesn't pollute the next chunk's
            # step time
            t0 = time.perf_counter()
            carry = jax.block_until_ready(jax.device_put(restored["state"]))
            restore_transfer_s = round(time.perf_counter() - t0, 1)
            probe2 = apply(carry[0])
            resume_delta = float(jnp.max(jnp.abs(
                probe.astype(jnp.float32) - probe2.astype(jnp.float32))))
            print(f"checkpoint+resume at step {step}: "
                  f"logits delta {resume_delta}", flush=True)
            assert resume_delta == 0.0, "resume changed the model"

    params = carry[0]
    live = max_offset_in_tree(params)
    bound = net.max_kernel_size // 2 - 0.01
    assert live <= bound + 1e-6, f"mu escaped bounds: {live} > {bound}"

    # stable step time: median of the steady-state chunks; chunks > 3x the
    # median are compile/transfer events (first chunk's compile, dispatch
    # hiccups), reported in chunk_ms_per_step but excluded from the spread
    med = float(np.median(chunk_ms))
    steady = [c for c in chunk_ms if c < 3 * med] or chunk_ms
    stability = (max(steady) - min(steady)) / (sum(steady) / len(steady))
    first_w = float(np.mean(losses[:20]))
    last_w = float(np.mean(losses[-20:]))
    record = {
        "variant": args.variant,
        "dau_units": net.num_dau_units(),
        "steps": len(losses),
        "loss_first20_mean": round(first_w, 4),
        "loss_last20_mean": round(last_w, 4),
        "loss_curve_every10": [round(float(l), 4) for l in losses[::10]],
        "step_ms_steady_mean": round(sum(steady) / len(steady), 2),
        "step_ms_spread_frac": round(stability, 4),
        "chunk_ms_per_step": [round(c, 2) for c in chunk_ms],
        "resume_logits_delta": resume_delta,
        "restore_transfer_s": restore_transfer_s,
        "final_max_abs_mu": round(float(live), 4),
        "mu_bound": bound,
        "device": dict(describe_devices(),
                       card=(card_name_and_power_limit()
                             if jax.devices()[0].platform == "gpu" else None)),
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items()
                      if k != "loss_curve_every10"}), flush=True)
    assert last_w < first_w, "loss did not descend"
    print("TRAIN_OK", flush=True)


if __name__ == "__main__":
    main()
