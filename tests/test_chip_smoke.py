"""chip_smoke.py's host references, its refusal to run without a GPU, and
the shared compile-cache placement."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand_csr(n, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < density) * rng.integers(1, 4, (n, n))
    return d.astype(np.float64), sp.csr_matrix(d)


def test_a2_nnz_matches_dense():
    d, csr = _rand_csr(300, 0.02, 1)
    assert chip_smoke.a2_nnz(csr, block=64) == int(((d @ d) != 0).sum())


def test_a2_checksum_identity():
    d, csr = _rand_csr(200, 0.05, 2)
    assert chip_smoke.a2_checksum(csr) == pytest.approx((d @ d).sum(),
                                                        rel=1e-12)


def test_bfs_validator_accepts_tree_rejects_corruption():
    d, _ = _rand_csr(120, 0.03, 3)
    d = np.maximum(d, d.T)
    csr = sp.csr_matrix(d)
    root = int(np.flatnonzero(np.diff(csr.indptr) > 0)[0])
    levels = chip_smoke.bfs_levels_ref(csr, [root])[0]
    from scipy.sparse.csgraph import breadth_first_order

    _, pred = breadth_first_order(csr, root, directed=False)
    parents = np.where(levels >= 0, pred, -1)
    parents[root] = root
    keys = chip_smoke.edge_keys(csr.indptr, csr.indices)
    n = d.shape[0]
    assert chip_smoke.validate_bfs_tree(keys, n, root, parents, levels)
    v = int(np.flatnonzero(levels == 2)[0])
    bad = parents.copy()
    bad[v] = root  # a level-2 vertex is not adjacent to the root
    assert not chip_smoke.validate_bfs_tree(keys, n, root, bad, levels)
    bad_lv = levels.copy()
    bad_lv[v] += 1
    assert not chip_smoke.validate_bfs_tree(keys, n, root, parents, bad_lv)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    expect = os.path.join(REPO, ".jax_cache")
    if env_dir is not None:
        expect = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = expect
    code = ("import jax; from combblas_tpu.utils.compile_cache import "
            "enable_compile_cache as e; d = e(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split() == [expect, expect]


def test_compress_sorted_masked_skips_interspersed_padding():
    """Padding between real entries (the streamed SpGEMM's row windows)
    neither splits nor joins runs."""
    import jax.numpy as jnp

    from combblas_tpu.ops.coo import compress_sorted_masked

    sent = np.iinfo(np.int32).max
    row = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int32)
    col = np.array([3, 3, 5, sent, 3, 4, sent, sent], np.int32)
    val = np.array([1, 2, 3, 0, 4, 5, 0, 0], np.float32)
    c = compress_sorted_masked(jnp.asarray(row), jnp.asarray(col),
                               jnp.asarray(val), jnp.asarray(col != sent),
                               (2, 8), out_capacity=8)
    nnz = int(c.nnz)
    assert nnz == 4
    np.testing.assert_array_equal(np.asarray(c.row)[:nnz], [0, 0, 1, 1])
    np.testing.assert_array_equal(np.asarray(c.col)[:nnz], [3, 5, 3, 4])
    np.testing.assert_array_equal(np.asarray(c.val)[:nnz], [3, 3, 4, 5])


def test_bench_refuses_cpu_fallback():
    """Without an accelerator and without JAX_PLATFORMS=cpu the benchmark
    stops instead of timing the CPU."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "bench.py", "--smoke"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The whole smoke run on a machine with a GPU."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
