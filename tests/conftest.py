"""Test configuration: run on a virtual 8-device CPU mesh.

The tests exercise numerics and multi-device sharding on host CPU devices,
per the project's test strategy (SURVEY.md section 4.5). What only the GPU
can show is checked by `python chip_smoke.py` on the card; tests that need
the card carry the `gpu` marker and skip here (see the `gpu_device`
fixture).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402

# The quick tier (`pytest -m quick`): a <2-min edit-loop subset - the cheap
# unit files whole, the QUICK differential matrix, and one seed per engine
# per fuzz family. CI stays on the full suite (no -m).
_QUICK_FILES = {
    "test_utils.py", "test_checkpoint.py", "test_data.py",
    "test_export.py", "test_shared.py", "test_round2_features.py",
    "test_bench.py",
}
_QUICK_TESTS = (
    "test_op_vs_oracle.py::test_quick",
    "test_full_matrix.py::test_reference_quick_matrix",
    "test_op_vs_oracle.py::test_shim_off[",
    "test_distributed.py::test_eight_devices_available",
    "test_distributed.py::test_opt_shardings_keyed_by_tree_path",
    "test_distributed.py::test_param_shardings_shard_f_axis",
    "test_distributed.py::test_batch_sharding_places_batch_on_data_axis",
    "test_grad_checks.py::test_finite_difference_w",
    "test_grad_checks.py::test_jit_compile_once",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = item.nodeid.split("/")[-1]
        base = fname.split("::")[0]
        is_quick = base in _QUICK_FILES or any(
            fname.startswith(t) for t in _QUICK_TESTS)
        # one seed per engine per fuzz family (engine alternates with seed)
        if base == "test_fuzz.py" and (fname.endswith("[0]")
                                       or fname.endswith("[1]")):
            is_quick = True
        if is_quick:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked `gpu`; skips where there is none.

    Decided here, at run time, never at import or collection: every
    pytest-xdist worker must collect the same tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` there)")
    return gpus[0]
