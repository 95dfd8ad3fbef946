"""The main path needs only JAX, numpy and optax: each entry imports (and
the model trains) in a fresh interpreter in which `flax` and `orbax`
cannot be imported; the flax wrappers and Orbax checkpoints then fail with
an ImportError that names what is missing."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_BLOCK = textwrap.dedent("""
    import sys
    for _name in ("flax", "orbax", "orbax.checkpoint"):
        sys.modules[_name] = None  # import now raises ImportError
    sys.path.insert(0, {root!r})
""")


def _run(body, cwd=ROOT):
    code = _BLOCK.format(root=str(ROOT)) + textwrap.dedent(body)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("module", [
    "dau_convnet", "dau_convnet.ops", "dau_convnet.nn", "dau_convnet.models",
    "dau_convnet.models.alexnet", "dau_convnet.parallel", "bench",
    "chip_smoke", "__graft_entry__", "examples.train_alexnet_synth",
])
def test_main_path_imports_without_flax(module):
    r = _run(f"""
        import importlib
        importlib.import_module({module!r})
        assert "flax" not in [m.split(".")[0] for m in sys.modules
                              if sys.modules[m] is not None]
        print("IMPORTED")
    """)
    assert r.returncode == 0, r.stderr
    assert "IMPORTED" in r.stdout


def test_alexnet_trains_sharded_without_flax():
    r = _run("""
        import jax, jax.numpy as jnp, numpy as np, optax
        from dau_convnet.models import AlexNetDAU
        from dau_convnet.parallel import (init_sharded, make_mesh,
                                          make_train_step)
        model = AlexNetDAU(variant="small", num_classes=10)
        x = jnp.asarray(np.random.default_rng(0).random((2, 3, 67, 67)),
                        jnp.float32)
        y = jnp.asarray([1, 3])
        tx = optax.sgd(1e-3)
        mesh = make_mesh(jax.devices()[:1])
        state, sh = init_sharded(model, tx, mesh, x)
        step = make_train_step(model, tx, mesh, sh)
        losses = []
        for _ in range(2):
            state, loss = step(state, x, y)
            losses.append(float(loss))
        assert np.isfinite(losses).all(), losses
        print("TRAINED", losses)
    """)
    assert r.returncode == 0, r.stderr
    assert "TRAINED" in r.stdout


def test_flax_wrappers_need_flax():
    r = _run("""
        import dau_convnet.nn as nn_
        try:
            nn_.DAUConv2d
        except ImportError as exc:
            print("IMPORTERROR", exc)
    """)
    assert r.returncode == 0, r.stderr
    assert "IMPORTERROR" in r.stdout and "flax" in r.stdout


def test_orbax_checkpoint_names_the_extra():
    r = _run("""
        from dau_convnet.utils import checkpoint
        try:
            checkpoint.latest_step("unused")
        except ImportError as exc:
            print("IMPORTERROR", exc)
    """)
    assert r.returncode == 0, r.stderr
    assert "IMPORTERROR" in r.stdout and "'nn' extra" in r.stdout


# the package's former name: every other dau_convnet* package at the root
_FORMER = [p.name for p in ROOT.iterdir() if p.name.startswith("dau_convnet")
           and p.name != "dau_convnet" and (p / "__init__.py").exists()]


@pytest.mark.parametrize("sub", ["", ".ops", ".ops.dau_conv", ".models",
                                 ".parallel.train"])
def test_former_package_name_gives_the_same_modules(sub):
    assert len(_FORMER) == 1, _FORMER
    r = _run(f"""
        import importlib, warnings
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            old = importlib.import_module({_FORMER[0] + sub!r})
        new = importlib.import_module({"dau_convnet" + sub!r})
        assert old is new, (old, new)
        assert any(issubclass(w.category, DeprecationWarning)
                   for w in caught), caught
        print("SAME")
    """)
    assert r.returncode == 0, r.stderr
    assert "SAME" in r.stdout
