"""Benchmark: AlexNet-DAU training and serving throughput on one GPU.

Default mode (`--model alexnet`): the full AlexNet-DAU training step
(fwd+bwd+SGD) in images/sec, against the same net with 3x3 convolutions in
place of the DAU layers (`vs_baseline` = conv step time / DAU step time).
At the default variant and N=32 the small and large variants, N=128 and the
serving forward are measured in turn in the same process.

Other modes: `--model layer` is the reference's single-layer speedtest
(`test_DAUConvSpeedTest`, plugins/tensorflow/tests/dau_conv_test.py:
504-628: 2x1 units, k=9, N=32, S=128, 16x16 -> F=32, fwd+bwd, against a 3x3
conv of the same shape); `--model inference` the serving forward with
phase tables precomputed from frozen weights; `--model memtest` a long
chained run checking numerical health (reference `test_DAUConvMemtest`).

Prints one JSON line. It runs in one process and needs a GPU: without one
it exits non-zero and prints no result. Compile time is reported apart
from the timed window.

    python bench.py [--model alexnet|layer|inference|memtest] [--variant ...]
"""

import argparse
import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from dau_convnet.utils.device import (card_name_and_power_limit,
                                      configure_compile_cache,
                                      describe_devices, require_gpu)

# Published peaks per device kind, for roofline and utilization shares.
# A device kind missing here is an error, never a default.
PEAKS = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5 part at 700 W: dense
    # (no sparsity) bf16 tensor-core rate and HBM3 bandwidth.
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet, SXM, 700 W"},
}

ALEXNET_IMAGE_HW = 227
# (S, F, H=W) of the four AlexNet-DAU layers at 227x227 input
ALEXNET_DAU_LAYERS = ((96, 256, 27), (256, 384, 13), (384, 384, 13),
                      (384, 256, 13))


def peak_rates(device_kind: str) -> dict:
    """The published peaks of `device_kind` (KeyError if unknown)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add them "
            "to bench.PEAKS with their source") from None


def _compile_scan(step, carry, length):
    def body(c, _):
        return step(c), None

    fn = jax.jit(lambda c: jax.lax.scan(body, c, None, length=length)[0])
    t0 = time.perf_counter()
    compiled = fn.lower(carry).compile()
    return compiled, time.perf_counter() - t0


def _best_wall(compiled, carry, reps=3):
    jax.block_until_ready(compiled(carry))  # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(carry))
        best = min(best, time.perf_counter() - t0)
    return best


def time_chained(step, carry, iters, pairs=3):
    """Per-step time of `step` chained data-dependently inside one jitted
    lax.scan (each step's outputs feed the next, so the device runs them
    in order); fixed costs (dispatch, transfer) cancel by differencing two
    scan lengths.

    Returns (median step seconds over `pairs`, each pair's ms, compile
    seconds of both scan lengths)."""
    n1 = max(1, iters // 5)
    n2 = max(iters, 2 * n1)
    short, c1 = _compile_scan(step, carry, n1)
    long_, c2 = _compile_scan(step, carry, n2)
    dts = []
    for _ in range(pairs):
        t1 = _best_wall(short, carry)
        t2 = _best_wall(long_, carry)
        dts.append((t2 - t1) / (n2 - n1) if t2 > t1 else t2 / n2)
    return (sorted(dts)[len(dts) // 2], [round(d * 1e3, 4) for d in dts],
            round(c1 + c2, 3))


def _dtype(name):
    return jnp.bfloat16 if name == "bf16" else jnp.float32


def _images(n, dtype, hw=ALEXNET_IMAGE_HW):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((n, 3, hw, hw)), dtype)
    labels = jnp.asarray(rng.integers(0, 1000, (n,)))
    return x, labels


def gather_flops(variant: str, n: int) -> float:
    """Algorithmic FLOPs of the DAU layers per training step: the minimal
    work of the reference's 4-tap gather formulation (fwd + input grad +
    3 derivative tables, 2 FLOPs/MAC). An algorithmic utilization against
    this is how close the step is to the floor of the math itself; the
    engine formulations (dense synthesized conv: ~ks^2/(4G) more, fourier:
    ~bins/(H*W*4G) more) sit between it and the chip's peak."""
    from dau_convnet.models.alexnet import ALEXNET_DAU_VARIANTS
    u0, u1 = ALEXNET_DAU_VARIANTS[variant]
    return float(sum(2 * n * s * u0 * u1 * f * hw * hw * 4 * 5
                     for s, f, hw in ALEXNET_DAU_LAYERS))


def measure_train_step(model, n, dtype, iters, image_hw=ALEXNET_IMAGE_HW):
    """(step seconds, pairs ms, compile seconds) of one SGD training step
    of `model` (an `init`/`apply` model) on a fixed batch."""
    import optax

    x, labels = _images(n, dtype, image_hw)
    tx = optax.sgd(1e-4)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)

    def step(carry):
        params, opt_state = carry

        def loss_fn(p):
            logits = model.apply(p, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()

        grads = jax.grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state

    return time_chained(step, (params, tx.init(params)), iters)


def bench_alexnet(variant, n, dtype_name, engine, iters,
                  image_hw=ALEXNET_IMAGE_HW):
    """The training-step cell: AlexNet-DAU against the conv3x3 net."""
    from dau_convnet.models import AlexNetConv, AlexNetDAU

    dtype = _dtype(dtype_name)
    dau = AlexNetDAU(variant=variant, dtype=dtype, engine=engine)
    t_dau, dau_pairs, dau_compile = measure_train_step(
        dau, n, dtype, iters, image_hw)
    t_conv, conv_pairs, conv_compile = measure_train_step(
        AlexNetConv(dtype=dtype), n, dtype, iters, image_hw)
    return {
        "metric": (f"alexnet_dau_{variant}_trainstep_images_per_sec"
                   f"(N{n},{image_hw}x{image_hw},{dtype_name})"),
        "value": round(n / t_dau, 1),
        "unit": "images/sec",
        "vs_baseline": round(t_conv / t_dau, 4),
        "detail": {
            "dau_step_ms": round(t_dau * 1e3, 3),
            "conv3x3_step_ms": round(t_conv * 1e3, 3),
            "dau_step_pairs_ms": dau_pairs,
            "conv3x3_step_pairs_ms": conv_pairs,
            "dau_compile_s": dau_compile,
            "conv3x3_compile_s": conv_compile,
            "dau_units": dau.num_dau_units(),
            "engine": engine,
            "gather_flops": gather_flops(variant, n),
        },
    }


def bench_alexnet_inference(variant, n, dtype_name, engine, iters,
                            image_hw=ALEXNET_IMAGE_HW):
    """Serving throughput: the fwd-only logits with the phase tables
    precomputed from the frozen params (`AlexNetDAU.phi_tables`), against
    the plain DAU forward and the conv3x3 forward. vs_baseline = conv fwd
    time / DAU serving time."""
    from dau_convnet.models import AlexNetConv, AlexNetDAU

    dtype = _dtype(dtype_name)
    x, _ = _images(n, dtype, image_hw)

    def fwd_time(model, variables, **kw):
        # data-dependent chain: fold the logits back into the input
        def step(c):
            logits = model.apply(variables, c, **kw)
            return c + (jnp.sum(logits) * 1e-30).astype(c.dtype)

        return time_chained(step, x, iters)

    dau = AlexNetDAU(variant=variant, dtype=dtype, engine=engine)
    dau_vars = jax.jit(dau.init)(jax.random.PRNGKey(0), x)
    t_plain, _, c_plain = fwd_time(dau, dau_vars)
    tables = jax.jit(lambda v: dau.phi_tables(v, (image_hw, image_hw)))(
        dau_vars)
    t_serving, _, c_serving = fwd_time(dau, dau_vars, phi_tables=tables)
    conv = AlexNetConv(dtype=dtype)
    t_conv, _, c_conv = fwd_time(
        conv, jax.jit(conv.init)(jax.random.PRNGKey(0), x))
    return {
        "metric": (f"alexnet_dau_{variant}_inference_images_per_sec"
                   f"(N{n},{image_hw}x{image_hw},{dtype_name},phi_cached)"),
        "value": round(n / t_serving, 1),
        "unit": "images/sec",
        "vs_baseline": round(t_conv / t_serving, 4),
        "detail": {
            "dau_serving_ms": round(t_serving * 1e3, 3),
            "dau_plain_fwd_ms": round(t_plain * 1e3, 3),
            "conv3x3_fwd_ms": round(t_conv * 1e3, 3),
            "phi_cache_speedup": round(t_plain / t_serving, 3),
            "compile_s": round(c_plain + c_serving + c_conv, 3),
            "engine": engine,
        },
    }


def bench_memtest(dtype_name, iters, n=32, s=128, f=256, g=2, hw=6):
    """Long-run stability check - the analogue of the reference's
    `test_DAUConvMemtest` (10k re-runs for leak detection with offsets
    initialized beyond bounds, dau_conv_test.py:635-682). Under XLA there is
    no allocator to leak, so this checks numerical health over many chained
    steps with the clip path exercised."""
    from dau_convnet.ops import DAUConvSettings, dau_conv2d_op

    dtype = _dtype(dtype_name)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((n, s, hw, hw)), dtype)
    err = jnp.asarray(rng.standard_normal((n, f, hw, hw)), dtype)
    w = jnp.asarray(rng.standard_normal((1, s, g, f)) * 0.1, dtype)
    # beyond-bounds init exercises the clip path (reference inits +-10 on k=9)
    mu1 = jnp.asarray(rng.uniform(-10, 10, (1, s, g, f)), dtype)
    mu2 = jnp.asarray(rng.uniform(-10, 10, (1, s, g, f)), dtype)
    sigma = jnp.full((1,), 0.5, dtype)
    cfg = DAUConvSettings(
        kernel_size=9, compute_sigma_grad=False,
        precision="default" if dtype_name == "bf16" else "highest")
    bound = 4 - 0.1
    lr = jnp.asarray(1e-5, dtype)

    def step(carry):
        def f_(x, w, mu1, mu2):
            y = dau_conv2d_op(cfg, x, w, jnp.clip(mu1, -bound, bound),
                              jnp.clip(mu2, -bound, bound), sigma)
            return jnp.vdot(y, err)

        g_ = jax.grad(f_, argnums=(0, 1, 2, 3))(*carry)
        return tuple(a - lr * gg.astype(a.dtype) for a, gg in zip(carry, g_))

    carry = (x, w, mu1, mu2)
    compiled, compile_s = _compile_scan(step, carry, iters)
    jax.block_until_ready(compiled(carry))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(carry))
    dt = time.perf_counter() - t0
    finite = all(bool(jnp.all(jnp.isfinite(a.astype(jnp.float32))))
                 for a in out)
    return {
        "metric": f"memtest_steps_per_sec({iters}_chained_steps,{dtype_name})",
        "value": round(iters / dt, 1),
        "unit": "steps/sec",
        "vs_baseline": 1.0 if finite else 0.0,
        "detail": {"all_finite": finite, "total_s": round(dt, 3),
                   "compile_s": round(compile_s, 3)},
    }


def bench_layer(n, s, f, hw, dtype_name, engine, iters, static_max_offset):
    """The reference speedtest layer, fwd+bwd, against a 3x3 conv."""
    from dau_convnet.ops import DAUConvSettings, dau_conv2d_op

    dtype = _dtype(dtype_name)
    g = 2  # dau_units (2, 1), reference speedtest config
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((n, s, hw, hw)), dtype)
    err = jnp.asarray(rng.standard_normal((n, f, hw, hw)), dtype)
    w = jnp.asarray(rng.standard_normal((1, s, g, f)) * 0.1, dtype)
    bound = 4 - 0.01
    # offsets must honor the static promise (the op clips |mu| to it); the
    # reference speedtest inits +-3 on k=9
    mu_init = min(3.0, static_max_offset)
    mu1 = jnp.asarray(rng.uniform(-mu_init, mu_init, (1, s, g, f)), dtype)
    mu2 = jnp.asarray(rng.uniform(-mu_init, mu_init, (1, s, g, f)), dtype)
    sigma = jnp.full((1, s, g, f), 0.5, dtype)
    # static_max_offset=3 mirrors what the reference's runtime tier dispatch
    # achieves on this config (offsets init +-3 on k=9 -> smallest tier);
    # sigma is not trained by default in the reference, so no sigma table.
    cfg = DAUConvSettings(kernel_size=9, mu_learning_rate_factor=1.0,
                          static_max_offset=static_max_offset,
                          compute_sigma_grad=False,
                          precision="highest" if dtype_name == "f32" else "default",
                          engine=engine)
    lr = jnp.asarray(1e-6, dtype)

    def dau_step(carry):
        def f_(x, w, mu1, mu2):
            y = dau_conv2d_op(cfg, x, w, jnp.clip(mu1, -bound, bound),
                              jnp.clip(mu2, -bound, bound), sigma)
            return jnp.vdot(y, err)

        grads = jax.grad(f_, argnums=(0, 1, 2, 3))(*carry)
        # SGD-like update chains each iteration to the previous one
        return tuple(a - lr * g_ for a, g_ in zip(carry, grads))

    k3 = jnp.asarray(rng.standard_normal((f, s, 3, 3)) * 0.1, dtype)

    def conv_step(carry):
        def f_(x, k):
            y = jax.lax.conv_general_dilated(
                x, k, (1, 1), ((1, 1), (1, 1)),
                dimension_numbers=("NCHW", "OIHW", "NCHW"))
            return jnp.vdot(y, err)

        grads = jax.grad(f_, argnums=(0, 1))(*carry)
        return tuple(a - lr * g_ for a, g_ in zip(carry, grads))

    t_dau, dau_pairs, dau_compile = time_chained(
        dau_step, (x, w, mu1, mu2), iters)
    t_conv, conv_pairs, conv_compile = time_chained(conv_step, (x, k3), iters)
    off_tag = f",off{static_max_offset:g}" if static_max_offset != 3.0 else ""
    return {
        "metric": (f"dau_layer_fwdbwd_images_per_sec(N{n},S{s},{hw}x{hw},"
                   f"F{f},2x1units,k9,{dtype_name},{engine}{off_tag})"),
        "value": round(n / t_dau, 1),
        "unit": "images/sec",
        "vs_baseline": round(t_conv / t_dau, 4),
        "detail": {
            "dau_ms": round(t_dau * 1e3, 4),
            "conv3x3_ms": round(t_conv * 1e3, 4),
            "dau_pairs_ms": dau_pairs,
            "conv3x3_pairs_ms": conv_pairs,
            "compile_s": round(dau_compile + conv_compile, 3),
        },
    }


def _as_variant(rec):
    return {"images_per_sec": rec["value"],
            "vs_baseline": rec["vs_baseline"], **rec["detail"]}


def run(args, peaks):
    """The JSON record of the chosen mode (see the module docstring)."""
    if args.model == "layer":
        return bench_layer(args.N, args.S, args.F, args.HW, args.dtype,
                           args.engine, args.iters, args.static_max_offset)
    if args.model == "memtest":
        return bench_memtest(args.dtype, args.iters)
    if args.model == "inference":
        return bench_alexnet_inference(args.variant, args.N, args.dtype,
                                       args.engine, args.iters)
    rec = bench_alexnet(args.variant, args.N, args.dtype, args.engine,
                        args.iters)
    t_dau = rec["detail"]["dau_step_ms"] / 1e3
    rec["detail"]["gather_mfu_pct"] = round(
        rec["detail"]["gather_flops"] / t_dau / peaks["bf16_flops_per_s"]
        * 100, 2)
    if args.variant == "default" and args.N == 32:
        rec["detail"]["variants"] = {
            "small": _as_variant(bench_alexnet(
                "small", 32, args.dtype, args.engine, args.iters)),
            "large": _as_variant(bench_alexnet(
                "large", 32, args.dtype, args.engine, args.iters)),
            "N128": _as_variant(bench_alexnet(
                "default", 128, args.dtype, args.engine, args.iters)),
            "inference": _as_variant(bench_alexnet_inference(
                "default", 32, args.dtype, args.engine, 50)),
        }
    return rec


def main():
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--model", default="alexnet",
                    choices=["layer", "alexnet", "inference", "memtest"])
    ap.add_argument("--variant", default="default",
                    choices=["small", "default", "large"])
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--S", type=int, default=128)
    ap.add_argument("--F", type=int, default=32)
    ap.add_argument("--HW", type=int, default=16)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--dtype", default=None, choices=["f32", "bf16"])
    ap.add_argument("--engine", default=None, choices=["xla", "fourier"])
    ap.add_argument("--static-max-offset", dest="static_max_offset",
                    type=float, default=3.0,
                    help="layer model only: the static tap bound (the "
                         "trace-time stand-in for the reference's runtime "
                         "tier dispatch); smaller = smaller synthesized "
                         "kernel.")
    args = ap.parse_args()
    if args.dtype is None:
        # production dtype for the model benchmarks; oracle-exact f32 for the
        # layer microbench (comparable to the reference's fp32 CUDA numbers)
        args.dtype = "f32" if args.model == "layer" else "bf16"
    if args.engine is None:
        args.engine = "xla" if args.model == "layer" else "fourier"
    if args.iters is None:
        args.iters = {"alexnet": 20, "layer": 100, "memtest": 2000,
                      "inference": 50}[args.model]

    configure_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    devices = require_gpu()
    device = describe_devices(devices)
    peaks = peak_rates(device["kind"])
    rec = run(args, peaks)
    rec["detail"]["device"] = dict(device, card=card_name_and_power_limit())
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
