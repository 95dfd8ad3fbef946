"""chip_smoke.py off the card: it refuses the CPU, and each phase runs at
tiny widths here (the four-device phase on 4 virtual CPU devices). The
card itself runs the script; `test_layer_numerics_on_gpu` is the one test
that needs it."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_phase_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.phase_device()


def test_main_returns_nonzero_without_result_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "configure_compile_cache", lambda d: d)
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert "needs an NVIDIA GPU" in out


def test_script_exits_nonzero_on_cpu():
    r = _run_script(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_rel_err_is_normalized_max():
    ref = np.array([1.0, -4.0, 2.0])
    assert chip_smoke.rel_err(ref + [0.0, 0.0, 0.4], ref) == pytest.approx(0.1)
    assert chip_smoke.rel_err(np.zeros(3), np.zeros(3)) == 0.0


def test_oracle_subset_matches_full_oracle():
    """Each subset quantity equals the full float64 oracle restricted to
    the subset (the subset evaluation is exact, not an approximation)."""
    from dau_convnet.ops import reference as ref

    case, idx = chip_smoke.layer_case(3, 2, 10, 12, 8)
    x, w, mu1, mu2, err = case
    full_y = ref.forward(x, w, mu1, mu2, [chip_smoke.SIGMA])
    full_b = ref.backward(x, err, w, mu1, mu2, [chip_smoke.SIGMA])
    full = [full_y, full_b[0], full_b[1], full_b[2], full_b[3]]
    for got, want, name in zip(chip_smoke.oracle_subset(case, idx),
                               chip_smoke.subset_of(full, idx),
                               chip_smoke.NAMES):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(16, 16, 14), (24, 32, 9), (8, 40, 12)],
                         ids=["s16f16", "s24f32", "s8f40"])
def test_check_layer_tiny(shape):
    s, f, hw = shape
    errs = chip_smoke.check_layer("tiny", 2, s, f, hw)
    assert set(errs) == set(chip_smoke.NAMES)
    for e_b, e_bf, e_a, e_x in errs.values():
        assert e_b <= chip_smoke.ORACLE_TOL
        assert e_bf <= chip_smoke.ORACLE_TOL
        assert e_a < chip_smoke.BF16_ABS_TOL


def test_phase_train_tiny():
    out = chip_smoke.phase_train(n=2, image_hw=67, steps=3, timed=1)
    assert out["losses"][-1] < out["losses"][0]
    assert out["compile_s"] > 0 and out["step_s"] > 0


def test_phase_serve_tiny():
    assert chip_smoke.phase_serve(n=2, image_hw=67) <= chip_smoke.SERVE_TOL


def test_phase_four_on_virtual_devices():
    res = chip_smoke.phase_four(jax.devices()[:4], n=8, image_hw=67)
    assert set(res) == {"xla_dp4", "xla_dp2xtp2", "fourier_dp4",
                        "fourier_dp2xtp2"}
    for key, (loss_err, upd_err) in res.items():
        assert loss_err <= chip_smoke.FOUR_LOSS_TOL
        assert upd_err <= chip_smoke.FOUR_UPDATE_TOL


def test_batch_placement_check_rejects_a_replicated_batch():
    from dau_convnet.parallel import batch_sharding, make_mesh

    mesh = make_mesh(jax.devices()[:4], model=1)
    x = jnp.zeros((8, 3))
    chip_smoke._check_batch_placement(
        jax.device_put(x, batch_sharding(mesh)), mesh, 8)
    replicated = jax.device_put(
        x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    with pytest.raises(AssertionError):
        chip_smoke._check_batch_placement(replicated, mesh, 8)


def test_last_line_schema(monkeypatch, capsys):
    """With every phase stubbed, main prints exactly the contract's last
    line."""
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(chip_smoke, "configure_compile_cache", lambda d: d)
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: [Dev()])
    for name in ("phase_layers", "phase_train", "phase_serve"):
        monkeypatch.setattr(chip_smoke, name, lambda: None)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.gpu
def test_layer_numerics_on_gpu(gpu_device):
    """One real-width layer in both modes against the oracle, on the card
    (the full set runs in `python chip_smoke.py`)."""
    with jax.default_device(gpu_device):
        chip_smoke.check_layer("conv4", 2, 384, 384, 13)
