"""Train the 3-layer DAU ConvNet on CIFAR-10 (or digits / synthetic data).

In-framework equivalent of the reference's external example repo
(skokec/DAU-ConvNet-cifar10-example, linked from README.md:234): the
3-layer dau_conv2d network with batch norm, trained with SGD + momentum and
the reference defaults (mu_learning_rate_factor=500, sigma=0.5, units 2x2,
k=9).

Datasets (this environment has no network egress, so CIFAR-10 itself cannot
be downloaded here):
  --dataset digits     sklearn's bundled handwritten-digits set (1797 real
                       8x8 images, upscaled to 32x32x3): REAL data with a
                       held-out test split - the accuracy-validation run
                       (see docs/TRAINING_RESULTS.md for recorded numbers).
  --dataset synthetic  CIFAR-shaped random images with class-dependent
                       means (loop/scale demonstration only).
  --data-npz PATH      a real CIFAR-10 npz (keys x_train [N,32,32,3] uint8,
                       y_train, and optionally x_test/y_test): used verbatim
                       when supplied.

`--arch conv` trains the plain-3x3-conv control net of identical topology
(the sanity baseline: DAU learning dynamics should roughly match it on
easy data).

Usage (prefix JAX_PLATFORMS=cpu to train on the host CPU):
    python examples/train_cifar10.py --dataset digits --epochs 30
    python examples/train_cifar10.py --arch conv --dataset digits
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

import jax
import jax.numpy as jnp
import optax

from dau_convnet.models import ConvCifarNet, DAUCifarNet
from dau_convnet.utils.device import configure_compile_cache
from dau_convnet.utils.math import validate_dau_params
from dau_convnet.utils.tiers import (max_offset_in_tree, retier_offset,
                                     snap_kernel_tier)

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check_dau_health(params, kernel_size: int):
    """Host-side runtime guards between jit steps: the live equivalent of the
    reference's per-step NaN/offset-bound checks (dau_conv_op.cpp:258-262,
    dau_conv_forward.cpp:156-158). Raises ValueError on divergence."""
    for lname, lparams in params.items():
        if isinstance(lparams, dict) and "mu1" in lparams:
            validate_dau_params(
                lparams["weights"], lparams["mu1"], lparams["mu2"],
                lparams["sigma"], kernel_size=kernel_size)


def synthetic_cifar(n=2048, num_classes=10, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, (n,))
    # class-dependent means make the task learnable
    means = rng.normal(0, 0.5, (num_classes, 3, 1, 1)).astype(np.float32)
    x = rng.normal(0, 1.0, (n, 3, 32, 32)).astype(np.float32) + means[y]
    return x, y.astype(np.int32), x[:512], y[:512].astype(np.int32)


def synthetic_spatial(n=50000, num_classes=10, seed=0, n_test=2000,
                      distinct=False):
    """CIFAR-scale spatial-RELATION task (zero-egress stand-in for real
    CIFAR at full 50k x 32x32x3 scale): every image contains two
    Gaussian blobs; the class is encoded ONLY in the displacement vector
    between them (angle = class * 2pi/10, radius 9px, +-1px jitter), at a
    random absolute position, polarity-randomized per blob pair, over
    pixel noise with a distractor blob. No class-dependent color/intensity
    statistics exist, so a classifier must integrate features at
    class-specific relative offsets - the aggregation-by-displacement
    regime DAUs target (reference paper positioning) - rather than match
    local appearance.

    distinct=False (the original task): the two blobs are IDENTICAL, so v
    and -v are indistinguishable and classes k and k + num_classes/2 alias
    exactly - the Bayes ceiling is 50% top-1 (measured: trained nets sit
    at 0.49-0.50 top-1 with ~0.97 accuracy onto the merged class-pairs,
    i.e. the task is solved to its information limit; see
    examples/analyze_spatial.py). distinct=True ('spatial2') breaks the
    ambiguity - blob B is wider (sigma 2.4 vs 1.4) at the same amplitude,
    so the displacement DIRECTION is identifiable and the ceiling is
    ~100%."""
    rng = np.random.default_rng(seed)
    total = n + n_test
    y = rng.integers(0, num_classes, (total,))
    size = 32
    r = 9.0
    ang = 2 * np.pi * y / num_classes
    jitter = rng.uniform(-1, 1, (2, total))
    dx = r * np.cos(ang) + jitter[0]
    dy = r * np.sin(ang) + jitter[1]
    # blob A center anywhere such that both blobs stay in-frame
    ax = rng.uniform(np.maximum(3, 3 - dx), np.minimum(size - 3, size - 3 - dx))
    ay = rng.uniform(np.maximum(3, 3 - dy), np.minimum(size - 3, size - 3 - dy))
    bx, by = ax + dx, ay + dy
    # distractor at an unrelated position
    cx = rng.uniform(3, size - 3, total)
    cy = rng.uniform(3, size - 3, total)
    sign = rng.choice([-1.0, 1.0], total).astype(np.float32)
    ii = np.arange(size, dtype=np.float32)
    x = rng.normal(0, 0.3, (total, size, size)).astype(np.float32)
    sig_b = 2.4 if distinct else 1.4
    for px, py, amp, sg in ((ax, ay, sign, 1.4), (bx, by, sign, sig_b),
                            (cx, cy, 0.7 * sign, 1.4)):
        gx = np.exp(-0.5 * ((ii[None, :] - px[:, None]) / sg) ** 2)
        gy = np.exp(-0.5 * ((ii[None, :] - py[:, None]) / sg) ** 2)
        x += amp[:, None, None] * gy[:, :, None] * gx[:, None, :]
    x = np.broadcast_to(x[:, None], (total, 3, size, size)).reshape(
        total, 3, size, size).copy()
    y = y.astype(np.int32)
    return x[:n], y[:n], x[n:], y[n:]


def digits_32x32(test_frac=0.2, seed=0):
    """sklearn's bundled digits set as 32x32x3 NCHW: each real 8x8 image is
    4x nearest-upscaled and replicated across channels; a stratified split
    holds out `test_frac` for the accuracy measurement."""
    from sklearn.datasets import load_digits

    d = load_digits()
    x = d.images.astype(np.float32) / 16.0 - 0.5         # (N, 8, 8)
    x = x.repeat(4, axis=1).repeat(4, axis=2)            # (N, 32, 32)
    x = np.broadcast_to(x[:, None], (x.shape[0], 3, 32, 32)).copy()
    y = d.target.astype(np.int32)
    rng = np.random.default_rng(seed)
    test_idx = []
    for cls in range(10):
        cls_idx = np.flatnonzero(y == cls)
        take = int(round(len(cls_idx) * test_frac))
        test_idx.append(rng.permutation(cls_idx)[:take])
    test_idx = np.concatenate(test_idx)
    mask = np.zeros(len(y), bool)
    mask[test_idx] = True
    return x[~mask], y[~mask], x[mask], y[mask]


def load_data(args):
    if args.data_npz:
        d = np.load(args.data_npz)
        x = (d["x_train"].astype(np.float32) / 255.0 - 0.5).transpose(0, 3, 1, 2)
        y = d["y_train"].astype(np.int32).reshape(-1)
        if "x_test" in d:
            xt = (d["x_test"].astype(np.float32) / 255.0 - 0.5).transpose(0, 3, 1, 2)
            yt = d["y_test"].astype(np.int32).reshape(-1)
        else:
            # shuffle before the 90/10 carve: a class-sorted npz would
            # otherwise yield a single-class test set
            perm = np.random.default_rng(0).permutation(len(x))
            x, y = x[perm], y[perm]
            n = int(len(x) * 0.9)
            x, xt, y, yt = x[:n], x[n:], y[:n], y[n:]
        return x, y, xt, yt
    if args.dataset == "digits":
        return digits_32x32()
    if args.dataset == "spatial":
        return synthetic_spatial(n=args.train_size)
    if args.dataset == "spatial2":
        return synthetic_spatial(n=args.train_size, distinct=True)
    return synthetic_cifar()


def save_params_npz(path, params, batch_stats):
    """Record the trained params/batch_stats as one npz - the artifact that
    `load_params_npz` + `set_dau_variables_manually` re-install
    (tests/test_models.py::test_recorded_digits_params_load)."""
    from dau_convnet.utils.checkpoint import save_params_npz as _save
    _save(path, params=params, batch_stats=batch_stats)


def main():
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--steps", type=int, default=None,
                    help="total train steps (overrides --epochs)")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--dataset",
                    choices=["synthetic", "digits", "spatial", "spatial2"],
                    default="synthetic")
    ap.add_argument("--train-size", type=int, default=50000,
                    help="train-set size for --dataset spatial (CIFAR scale)")
    ap.add_argument("--data-npz", default=None,
                    help="real CIFAR-10 npz (overrides --dataset)")
    ap.add_argument("--arch", choices=["dau", "conv"], default="dau")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-params", default=None,
                    help="write final params/batch_stats to this npz")
    ap.add_argument("--check-every", type=int, default=100,
                    help="host-side param guard + kernel-tier check interval")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="eval on the test split every N steps (0 = only at end)")
    ap.add_argument("--bn-momentum", type=float, default=None,
                    help="batch-norm EMA momentum; default scales the "
                         "reference's 0.9999 (a ~10k-step horizon, "
                         "README.md:252) down to the run length so eval-mode "
                         "running stats can actually converge")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "xla", "fourier"],
                    help="DAU engine; fourier is ~10x fewer FLOPs at these "
                         "shapes (CPU-bound runs), oracle-exact at f32")
    ap.add_argument("--sigma-trainable", action="store_true",
                    help="learn the layer-shared sigma (reference "
                         "dau_sigma_trainable, dau_conv.py:254); the op "
                         "clips it into [0.3, blur support]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--auto-tier", action="store_true",
                    help="pick static_max_offset from live offsets and re-jit "
                         "when the tier grows (the reference's dynamic "
                         "kernel-size optimization, dau_conv_op.cpp:223-256)")
    args = ap.parse_args()
    configure_compile_cache(CHECKOUT)

    x_all, y_all, x_test, y_test = load_data(args)
    steps_per_epoch = max(1, len(x_all) // args.batch)
    total_steps = args.steps or args.epochs * steps_per_epoch
    # EMA horizon ~= 1/(1-m): cap it at ~4% of the run so the running
    # statistics track the (never-settling, mu_lr_factor-driven) DAU
    # activations. The reference's own 0.9999 assumes ImageNet-scale runs;
    # at 2750 digits steps it leaves running var ~80x stale and eval-mode
    # accuracy at chance (docs/TRAINING_RESULTS.md).
    bn_momentum = (args.bn_momentum if args.bn_momentum is not None
                   else min(0.9999, max(0.9, 1.0 - 25.0 / total_steps)))
    if args.arch == "conv":
        net = ConvCifarNet(train=True, bn_momentum=bn_momentum)
    else:
        net = DAUCifarNet(train=True, bn_momentum=bn_momentum,
                          dau_sigma_trainable=args.sigma_trainable,
                          engine=args.engine)
    print(f"arch={args.arch} train={len(x_all)} test={len(x_test)} "
          f"steps={total_steps} ({steps_per_epoch}/epoch) "
          f"bn_momentum={bn_momentum:.4f}", flush=True)

    rng = jax.random.PRNGKey(args.seed)
    sample = jnp.asarray(x_all[:args.batch])
    variables = jax.jit(net.init)(rng, sample)

    tx = optax.sgd(args.lr, momentum=0.9)
    opt_state = tx.init(variables["params"])

    if args.auto_tier and args.arch == "dau":
        # trace-time tier from the live offsets (+0.5 slack so small drifts
        # don't force a re-jit at every check)
        off = min(math.ceil(max_offset_in_tree(variables["params"]) + 0.5),
                  net.max_kernel_size // 2)
        net = net.clone(static_max_offset=float(off))
        print(f"auto-tier: static_max_offset={off} "
              f"(tier {snap_kernel_tier(off)})")

    def make_train_step(net):
        @jax.jit
        def train_step(params, batch_stats, opt_state, x, y):
            def loss_fn(p):
                logits, updates = net.apply(
                    {"params": p, "batch_stats": batch_stats}, x,
                    mutable=["batch_stats"])
                loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
                acc = (logits.argmax(-1) == y).mean()
                return loss, (updates["batch_stats"], acc)

            (loss, (bs, acc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            if args.arch == "dau":
                # keep param STORAGE in bounds like the reference's
                # in-place guard - boundary gradients keep flowing
                from dau_convnet.nn import project_dau_params
                params = project_dau_params(
                    params, kernel_size=net.max_kernel_size)
            return params, bs, opt_state, loss, acc
        return train_step

    train_step = make_train_step(net)

    eval_net = net.clone(train=False)

    @jax.jit
    def eval_logits(params, batch_stats, x):
        return eval_net.apply({"params": params, "batch_stats": batch_stats}, x)

    def test_accuracy(params, batch_stats):
        if len(x_test) == 0:
            return float("nan")
        correct = 0
        bs_eval = args.batch
        n_pad = (-len(x_test)) % bs_eval
        xt = np.concatenate([x_test, x_test[:n_pad]]) if n_pad else x_test
        for i in range(0, len(xt), bs_eval):
            logits = eval_logits(params, batch_stats,
                                 jnp.asarray(xt[i:i + bs_eval]))
            pred = np.asarray(logits.argmax(-1))
            end = min(i + bs_eval, len(x_test))
            correct += (pred[:end - i] == y_test[i:end]).sum()
        return correct / len(x_test)

    from dau_convnet.data import epoch_batches, prefetch_to_device

    params, batch_stats = variables["params"], variables["batch_stats"]
    data_rng = np.random.default_rng(args.seed + 1)
    t0 = time.time()
    step = 0
    while step < total_steps:
        batches = epoch_batches(x_all, y_all, args.batch, rng=data_rng)
        for x, y in prefetch_to_device(batches, size=2):
            params, batch_stats, opt_state, loss, acc = train_step(
                params, batch_stats, opt_state, x, y)
            if step % 50 == 0 or step == total_steps - 1:
                print(f"step {step:4d}  loss {float(loss):.4f}  "
                      f"acc {float(acc):.3f}  ({(time.time() - t0):.1f}s)",
                      flush=True)
            step += 1
            if args.eval_every and step % args.eval_every == 0:
                print(f"step {step:4d}  TEST acc "
                      f"{test_accuracy(params, batch_stats):.4f}", flush=True)
            if (args.check_every and step % args.check_every == 0
                    and args.arch == "dau"):
                # runtime guards on concrete params, between jit steps
                check_dau_health(params, net.max_kernel_size)
                if args.auto_tier:
                    # both directions: grow for correctness (the op clips to
                    # the static bound), shrink for speed (smaller synth
                    # kernel / fewer fourier bins) - the full replacement of
                    # the reference's per-step amax dispatch
                    live = max_offset_in_tree(params)
                    off = retier_offset(live, net.static_max_offset,
                                        net.max_kernel_size)
                    if off is not None:
                        print(f"offsets now {live:.2f}: re-jit "
                              f"static_max_offset {net.static_max_offset} "
                              f"-> {off}", flush=True)
                        net = net.clone(static_max_offset=off)
                        train_step = make_train_step(net)
            if step >= total_steps:
                break

    final_acc = test_accuracy(params, batch_stats)
    wall = time.time() - t0
    result = {
        "arch": args.arch,
        "dataset": "cifar10-npz" if args.data_npz else args.dataset,
        "steps": total_steps,
        "test_accuracy": round(float(final_acc), 4),
        "wall_s": round(wall, 1),
        "device": str(jax.devices()[0]),
    }
    if args.arch == "dau":
        # raw param + the effective (clipped) sigma the op actually uses;
        # the raw value can sit below the 0.3 floor by a momentum tail
        # (the in-graph clip zeroes the out-of-range gradient)
        result["sigma"] = {k: round(float(np.asarray(v["sigma"])[0]), 4)
                           for k, v in params.items() if "sigma" in v}
        result["sigma_effective"] = {
            k: round(min(max(v, 0.3), 1.6), 4)
            for k, v in result["sigma"].items()}
        result["sigma_trainable"] = bool(args.sigma_trainable)
    print(json.dumps(result), flush=True)

    if args.save_params:
        save_params_npz(args.save_params, params, batch_stats)
        print(f"saved params to {args.save_params}")
    if args.ckpt_dir:
        from dau_convnet.utils.checkpoint import save_checkpoint
        save_checkpoint(args.ckpt_dir, total_steps,
                        {"params": params, "batch_stats": batch_stats})
        print(f"saved checkpoint to {args.ckpt_dir}")


if __name__ == "__main__":
    main()
