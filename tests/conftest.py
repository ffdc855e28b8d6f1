"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU: the Pallas kernels in interpret mode, the XLA
twins as they are. Tests marked ``gpu`` need the card and skip here (the
``gpu`` fixture decides when the test runs, never at import).
``python chip_smoke.py`` runs them on the card as its first phase, with
``BGSA_TESTS_ON_GPU=1`` so this file leaves JAX's platform alone.
"""

import os

if not os.environ.get("BGSA_TESTS_ON_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not os.environ.get("BGSA_TESTS_ON_GPU"):
    jax.config.update("jax_platforms", "cpu")

# The persistent compile cache the engines use (JAX_COMPILATION_CACHE_DIR,
# else the checkout's .jax_cache): the heavy XLA-scan compiles (BitPAl
# golden) only cost their first run; 0.1 s, because the suite's many small
# XLA CPU steps (0.1-1 s compiles) are the band that re-pays every run.
from bgsa_tpu.pipeline import enable_compilation_cache  # noqa: E402

enable_compilation_cache(jax)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

import numpy as np
import pytest

# Multi-second integration tests (subprocess roles pay a ~3 s jax-import
# floor each; the differential module drives compiled reference
# binaries). Default `pytest tests/` runs everything; the quick
# dev tier is `pytest tests/ -m "not slow"` (~2 min warm).
_SLOW_TESTS = {
    "test_host_auto_from_jax_distributed",
    "test_dynamic_rebalances_and_merges_byte_equal",
    "test_host_auto_concurrent_roles",
    "test_dynamic_with_fasta_inputs",
    "test_hetero_dynamic_rebalances",
    "test_hetero_banded_and_cli",
    "test_hetero_static_matches_single",
    "test_resume_from_any_truncation_point",
    "test_resume_after_sigkill",
    "test_sample_data_matches_reference_golden",
    "test_banded_multihost_roles_merge_equals_single",
    "test_multihost_roles_merge_equals_single",
    "test_shard_resume_after_interruption",
    "test_merge_infers_dtype_from_sidecar",
    "test_cli_host_roles_and_merge",
    "test_pipeline_rare_n_uses_sidecar",
    "test_cli_accepts_fastx_inputs",
    "test_cli_profile_flag",
    "test_hetero_sparse_n_sidecar_and_uneven_tail",
    "test_dynamic_resume_republishes_lost_time_file",
    "test_pallas_semiglobal_interpret",
}
_SLOW_MODULES = {"test_reference_diff"}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if (item.name.split("[")[0] in _SLOW_TESTS
                or item.module.__name__ in _SLOW_MODULES):
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_codes(rng, shape, nchars=4):
    """Random symbol codes (ACGT by default)."""
    return rng.integers(0, nchars, size=shape).astype(np.int32)
