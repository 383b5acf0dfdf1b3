"""Test configuration: run on an 8-device virtual CPU platform.

Distributed paths are exercised exactly the way the reference exercises MPI
with ``mpiexec -n 4/16`` on one box (SURVEY.md §4): JAX's forced host platform
device count gives us a real 8-device mesh on CPU, so every shard_map/collective
path runs unmodified.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu_card``
fixture, which skips them when no card is present; ``python -m pytest -m gpu
tests/`` runs them on a machine with one.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

from combblas_tpu.utils.compile_cache import enable_compile_cache

jax.config.update("jax_platforms", "cpu")
# Persistent compilation cache: the suite is compile-bound, not compute-bound.
enable_compile_cache()

import gc
import shutil
import subprocess

import pytest

# Guard against vm.max_map_count exhaustion.  Compiled XLA:CPU executables
# each hold many mmap regions for as long as jit caches keep them alive; a full suite
# run can accumulate past the kernel's vm.max_map_count (65530 default) and
# the next mmap failure inside XLA surfaces as SIGSEGV/SIGABRT during
# compilation or executable (de)serialization.  Dropping the caches releases
# every region; the persistent compile cache makes the re-warm cheap.
_MAP_GUARD_THRESHOLD = 35_000


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where there is none")


def _n_maps() -> int:
    try:
        with open(f"/proc/{os.getpid()}/maps") as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux: no /proc, and no map_count limit either
        return 0


@pytest.fixture(autouse=True)
def _mmap_guard():
    yield
    if _n_maps() > _MAP_GUARD_THRESHOLD:
        jax.clear_caches()
        gc.collect()


@pytest.fixture
def gpu_card():
    """Skip unless an NVIDIA GPU is present.  The test process itself stays
    on the CPU, so a test that needs the card runs its work in a child
    process with the platform left to JAX."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
            [smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
