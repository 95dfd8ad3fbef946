"""bench.py off the card: its peak table, device checks and compile-cache
placement, and each benchmark function at tiny sizes on the CPU (the
rehearsal of the code paths; a time taken here is no device number)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402

from dau_convnet.utils import device as dev  # noqa: E402


def test_peak_table_h100():
    peaks = bench.peak_rates("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_flops_per_s"] == 989e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in peaks["source"]


@pytest.mark.parametrize("kind", ["cpu", "Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_unknown_kind_is_an_error(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peak_rates(kind)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert dev.configure_compile_cache(str(ROOT)) == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = dev.configure_compile_cache(str(ROOT))
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert dev.configure_compile_cache(str(ROOT)) == path  # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        dev.require_gpu()


def test_describe_devices():
    info = dev.describe_devices()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_bench_main_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "bench.py", "--model", "layer"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_gather_flops_scales_with_units_and_batch():
    small = bench.gather_flops("small", 32)
    assert bench.gather_flops("default", 32) == 2 * small
    assert bench.gather_flops("large", 32) == 4 * small
    assert bench.gather_flops("default", 64) == 2 * bench.gather_flops(
        "default", 32)


def test_bench_alexnet_tiny():
    rec = bench.bench_alexnet("small", 2, "bf16", "fourier", iters=2,
                              image_hw=67)
    d = rec["detail"]
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert d["dau_units"] == 368_640
    assert d["dau_compile_s"] > 0 and d["conv3x3_compile_s"] > 0
    assert "N2,67x67,bf16" in rec["metric"]


def test_bench_alexnet_inference_tiny():
    rec = bench.bench_alexnet_inference("default", 2, "bf16", "fourier",
                                        iters=2, image_hw=67)
    d = rec["detail"]
    assert rec["value"] > 0
    assert d["dau_serving_ms"] > 0 and d["conv3x3_fwd_ms"] > 0
    assert d["compile_s"] > 0


@pytest.mark.parametrize("engine,dtype", [("xla", "f32"), ("fourier", "bf16")])
def test_bench_layer_tiny(engine, dtype):
    rec = bench.bench_layer(2, 8, 4, 8, dtype, engine, iters=2,
                            static_max_offset=3.0)
    assert rec["value"] > 0
    assert f"{dtype},{engine})" in rec["metric"]


def test_bench_memtest_tiny():
    rec = bench.bench_memtest("f32", iters=3, n=2, s=4, f=4)
    assert rec["detail"]["all_finite"] and rec["vs_baseline"] == 1.0


def test_measure_train_step_on_any_init_apply_model():
    from dau_convnet.models import AlexNetConv

    t, pairs, compile_s = bench.measure_train_step(
        AlexNetConv(), 2, jnp.float32, iters=2, image_hw=67)
    assert np.isfinite(t) and t > 0 and len(pairs) == 3 and compile_s > 0
