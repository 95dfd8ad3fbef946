"""Confusion analysis of a trained spatial-task model.

The original `--dataset spatial` task has an exact class-aliasing: the two
blobs are identical, so the displacement v is indistinguishable from -v and
class k aliases class k + 5 - the Bayes top-1 ceiling is 50%. This tool
loads a saved params npz (train_cifar10.py --save-params), rebuilds the
matching eval net, and reports top-1, the accuracy onto the merged class
pairs (the information-limit metric for the aliased task), and the full
confusion matrix.

    python examples/analyze_spatial.py --params spatial_dau.npz \
        --arch dau --dataset spatial

(prefix JAX_PLATFORMS=cpu to run on the host CPU)
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np

from dau_convnet.utils.device import configure_compile_cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--params", required=True)
    ap.add_argument("--arch", choices=["dau", "conv"], default="dau")
    ap.add_argument("--dataset", choices=["spatial", "spatial2"],
                    default="spatial")
    ap.add_argument("--engine", choices=["auto", "xla", "fourier"],
                    default="fourier")
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    configure_compile_cache(CHECKOUT)

    from train_cifar10 import synthetic_spatial

    from dau_convnet.models import ConvCifarNet, DAUCifarNet
    from dau_convnet.utils.checkpoint import load_params_npz

    trees = load_params_npz(args.params)
    params, batch_stats = trees["params"], trees["batch_stats"]
    _, _, x_test, y_test = synthetic_spatial(
        n=50000, distinct=args.dataset == "spatial2")
    if args.arch == "dau":
        net = DAUCifarNet(train=False, engine=args.engine)
    else:
        net = ConvCifarNet(train=False)

    @jax.jit
    def logits_fn(x):
        return net.apply({"params": params, "batch_stats": batch_stats}, x)

    bs = args.batch
    n_pad = (-len(x_test)) % bs
    xt = np.concatenate([x_test, x_test[:n_pad]]) if n_pad else x_test
    preds = []
    for i in range(0, len(xt), bs):
        preds.append(np.asarray(
            logits_fn(jnp.asarray(xt[i:i + bs])).argmax(-1)))
    pred = np.concatenate(preds)[:len(x_test)]

    ncls = int(y_test.max()) + 1
    half = ncls // 2
    conf = np.zeros((ncls, ncls), int)
    np.add.at(conf, (y_test, pred), 1)
    print(f"top-1 accuracy: {(pred == y_test).mean():.4f}")
    print(f"pair (k vs k+{half} merged) accuracy: "
          f"{((pred % half) == (y_test % half)).mean():.4f}")
    print(f"fraction predicted exactly the aliased class: "
          f"{(pred == (y_test + half) % ncls).mean():.4f}")
    print("confusion (rows=true, cols=pred):")
    print(conf)


if __name__ == "__main__":
    main()
