"""Run-time setup shared by the entry points (bench.py, chip_smoke.py, the
examples): where compiled programs are cached, which device runs, and what
the card reports about itself."""

from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["configure_compile_cache", "require_gpu", "describe_devices",
           "card_name_and_power_limit"]


def configure_compile_cache(checkout_dir: str) -> str:
    """Place JAX's persistent compilation cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX uses it and nothing else is
    set here. Otherwise the cache is `<checkout_dir>/.jax_cache`, a fixed
    path (the path is part of the cache key, so it must not move between
    runs; `.gitignore` lists it)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(checkout_dir), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The JAX devices, if they are GPUs; RuntimeError otherwise. There is
    no CPU fallback: a time or a rate measured elsewhere is no GPU
    number."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX found platform "
            f"{devices[0].platform!r} ({devices[0].device_kind})")
    return devices


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one line per card, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W"), read in a child process that does
    not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def describe_devices(devices=None) -> dict:
    """Platform, device kind and count, as JAX reports them."""
    devices = jax.devices() if devices is None else devices
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}
