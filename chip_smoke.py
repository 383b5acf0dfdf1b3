"""Run the library's main paths once on one GPU and check every result.

Each phase drives a user entry point of ``combblas_tpu`` at a size users
run and compares it with an independent host reference (numpy/scipy):

  1. streamed A² (``seg2_prepare``/``seg2_step``, the benchmark headline):
     R-MAT scale 20, edgefactor 8, SSCA initiator; nnz(C) exact and the
     checksum within rtol 1e-4 of sum_k colsum(A)[k] * rowsum(A)[k];
  2. materialised A² (``spgemm_auto``, the ``cli spgemm`` path): Graph500
     scale 16, edgefactor 16, against scipy; structure exact, values rtol
     1e-5;
  3. BFS: ``bfs_batch_pull`` from 64 roots, ``bfs_local`` and
     ``bfs_dir_opt_local`` from one, on Graph500 scale 18, symmetrised;
     levels equal scipy's exactly and every parent passes the Graph500
     checks;
  4. connected components: ``fastsv_local`` and ``lacc_local`` on the same
     graph give scipy's partition;
  5. MCL: ``mcl_local`` on a planted partition (labels equal the planted
     blocks and a dense numpy MCL), and on the benchmark's SSCA scale-14
     configuration to convergence, with columns stochastic within 1e-5;
  6. SpMM: ``spmm`` with d = 128 on Graph500 scale 16 against scipy in
     float64, rtol 1e-4.

``--four`` runs instead, and alone, the distributed paths on four GPUs
(SUMMA, ring SUMMA, phased SUMMA and 3D SUMMA over 4 layers; distributed
BFS, FastSV and MCL) against the same single-GPU calls on the first card.

Usage::

    python chip_smoke.py              # one GPU, phases 1-6
    python chip_smoke.py --scale 22   # phase 1 at the benchmark's scale
    python chip_smoke.py --four       # four GPUs, distributed phase only

Every phase prints one JSON line (sizes, wall and compile seconds, peak
device memory, reference verdict).  Then come the cards' names and power
limits as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``.  No GPU, or any failed phase, exits
non-zero without the ``ok`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SSCA = (0.6, 0.4 / 3, 0.4 / 3, 0.4 / 3)
_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


# ---------------------------------------------------------------------------
# Host references: numpy/scipy only, independent of the library
# ---------------------------------------------------------------------------

def host_csr(row, col, val, shape):
    """float64 scipy CSR from coordinate arrays."""
    import scipy.sparse as sp

    return sp.csr_matrix(
        (np.asarray(val, np.float64), (np.asarray(row), np.asarray(col))),
        shape=shape)


_POOL_CSR = None


def _pool_init(indptr, indices, shape):
    global _POOL_CSR
    import scipy.sparse as sp

    _POOL_CSR = sp.csr_matrix(
        (np.ones(len(indices), np.float64), indices, indptr), shape=shape)


def _block_nnz(bounds):
    lo, hi = bounds
    return int((_POOL_CSR[lo:hi] @ _POOL_CSR).nnz)


def a2_row_blocks(n_rows: int, block: int = 4096):
    return [(lo, min(lo + block, n_rows)) for lo in range(0, n_rows, block)]


def a2_nnz(csr, block: int = 4096) -> int:
    """Exact nnz of A·A from scipy products of row blocks: each block of C
    is counted and discarded, so C is never held whole.  Values are
    replaced by ones, so no sum can cancel to zero.  (``_block_nnz`` is the
    same count for one block in a worker process.)"""
    blocks = a2_row_blocks(csr.shape[0], block)
    pat = csr.copy()
    pat.data = np.ones_like(pat.data)
    return sum(int((pat[lo:hi] @ pat).nnz) for lo, hi in blocks)


def a2_checksum(csr) -> float:
    """Sum of all entries of A·A, as sum_k colsum(A)[k] * rowsum(A)[k] in
    float64."""
    colsum = np.asarray(csr.sum(axis=0), np.float64).ravel()
    rowsum = np.asarray(csr.sum(axis=1), np.float64).ravel()
    return float(np.dot(colsum, rowsum))


def bfs_levels_ref(csr, roots) -> np.ndarray:
    """(R, n) int32 BFS levels from scipy's unweighted shortest paths;
    -1 where unreachable."""
    from scipy.sparse.csgraph import shortest_path

    d = shortest_path(csr, method="D", unweighted=True,
                      indices=np.asarray(roots))
    d = np.atleast_2d(d)
    return np.where(np.isfinite(d), d, -1).astype(np.int32)


def edge_keys(indptr, indices) -> np.ndarray:
    """Sorted int64 keys u * n + v of a CSR graph's edges (u, v)."""
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    return np.sort(rows * n + np.asarray(indices, np.int64))


def validate_bfs_tree(keys, n: int, root: int, parents, levels) -> bool:
    """Graph500 checks against the sorted edge keys of :func:`edge_keys`:
    the root is its own parent at level 0; every other visited vertex v has
    an edge (parents[v], v) and sits one level below its parent; unvisited
    vertices have no parent."""
    parents = np.asarray(parents).astype(np.int64)
    levels = np.asarray(levels).astype(np.int64)
    if parents[root] != root or levels[root] != 0:
        return False
    visited = levels >= 0
    if np.any(visited != (parents >= 0)):
        return False
    v = np.flatnonzero(visited)
    v = v[v != root]
    p = parents[v]
    if np.any(p >= n) or np.any(levels[p] != levels[v] - 1):
        return False
    want = p * n + v
    pos = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    return bool(np.all(keys[pos] == want))


def same_partition(a, b) -> bool:
    """Two labelings induce the same partition of the vertices."""
    a = np.asarray(a)
    b = np.asarray(b)
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def planted_partition(seed: int, blocks: int = 64, size: int = 64,
                      p_in: float = 0.5, inter: int = 2):
    """Symmetric edge lists of ``blocks`` random blocks of ``size`` vertices
    (each pair inside a block joined with probability ``p_in``) plus
    ``inter`` random edges per vertex to other blocks.  Returns (rows,
    cols, block_of_vertex)."""
    rng = np.random.default_rng(seed)
    n = blocks * size
    block = np.arange(n) // size
    ii, jj = np.triu_indices(size, 1)
    keep = rng.random((blocks, len(ii))) < p_in
    base = (np.arange(blocks) * size)[:, None]
    r_in = (base + ii[None, :])[keep]
    c_in = (base + jj[None, :])[keep]
    src = np.repeat(np.arange(n), inter)
    dst = rng.integers(0, n - size, len(src))
    dst = dst + size * (dst >= block[src] * size)  # skip the own block
    rows = np.concatenate([r_in, c_in, src, dst])
    cols = np.concatenate([c_in, r_in, dst, src])
    return rows, cols, block


def dense_mcl_labels(dense, inflation: float = 2.0, cutoff: float = 1e-4,
                     eps: float = 1e-3, max_iters: int = 100):
    """Plain dense MCL: add self loops, normalise columns, then expand,
    drop entries below ``cutoff``, inflate and normalise until the chaos
    falls below ``eps``; clusters are the connected components of the
    result's structure."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    m = np.asarray(dense, np.float64) + np.eye(dense.shape[0])
    m /= m.sum(axis=0, keepdims=True)
    for _ in range(max_iters):
        m = m @ m
        m[m < cutoff] = 0.0
        m = m ** inflation
        s = m.sum(axis=0, keepdims=True)
        m = np.divide(m, s, out=np.zeros_like(m), where=s > 0)
        if np.max(m.max(axis=0) - (m * m).sum(axis=0)) < eps:
            break
    _, labels = connected_components(sp.csr_matrix(m), directed=True,
                                     connection="weak")
    return labels


def sort_impls(hlo_text: str) -> dict:
    """Sort implementations in an optimized GPU HLO module: CUB radix-sort
    custom calls and XLA's own comparison sorts."""
    return {"cub_radix": hlo_text.count("__cub$DeviceRadixSort"),
            "xla_sort": hlo_text.count(" sort(")}


# ---------------------------------------------------------------------------
# Device-side phases
# ---------------------------------------------------------------------------

class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, and the number of
    backend compiles, read from JAX's monitoring events."""

    def __init__(self):
        import jax

        self.secs = 0.0
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in _COMPILE_EVENTS:
            self.secs += duration
            self.count += event == _COMPILE_EVENTS[-1]

    def mark(self):
        return self.secs, self.count

    def since(self, mark):
        return {"compile_secs": self.secs - mark[0],
                "compiles": self.count - mark[1]}


def _peak_bytes() -> dict:
    import jax

    return {"peak_bytes_in_use": [
        int((d.memory_stats() or {}).get("peak_bytes_in_use", -1))
        for d in jax.local_devices()]}


def _coo_host(a):
    nnz = int(a.nnz)
    return (np.asarray(a.row)[:nnz], np.asarray(a.col)[:nnz],
            np.asarray(a.val)[:nnz])


def _graph500(seed: int, scale: int, edgefactor: int, symmetric: bool,
              probs=None):
    import jax
    from combblas_tpu.gen.rmat import G500_PROBS, rmat_matrix

    return rmat_matrix(jax.random.PRNGKey(seed), scale=scale,
                       edgefactor=edgefactor, symmetrize=symmetric,
                       remove_self_loops=symmetric,
                       probs=probs or G500_PROBS)


def phase_seg2(clock, seed: int, scale: int, workers: int = 0) -> dict:
    """Streamed A² through seg2 over every slab.  With ``workers`` the
    exact host count runs in a process pool while the device works."""
    import multiprocessing

    from combblas_tpu.ops.spgemm_seg import (
        _seg2_flat_digest_step,
        _seg2_slab_digest_step,
        seg2_prepare,
        seg2_step,
        seg_zero_state,
    )
    from combblas_tpu.semiring import PLUS_TIMES

    a = _graph500(seed, scale, 8, False, SSCA)
    row, col, val = _coo_host(a)
    csr = host_csr(row, col, val, a.shape)
    pool = None
    if workers:
        pool = multiprocessing.get_context("spawn").Pool(
            workers, initializer=_pool_init,
            initargs=(csr.indptr, csr.indices, csr.shape))
        pool_job = pool.map_async(_block_nnz, a2_row_blocks(a.shape[0]))
    mark = clock.mark()
    t0 = time.perf_counter()
    prep = seg2_prepare(a, a)
    cfg = prep[1]
    plan_secs = time.perf_counter() - t0
    first = {}
    for s, sl in enumerate(cfg["slabs"]):
        first.setdefault((sl["w"], sl["s_pad"], sl["nnz_cap"], sl["flat"],
                          sl["flat_stream_cap"]), s)
    t0 = time.perf_counter()
    for s in first.values():  # compile every shape once; digest discarded
        int(seg2_step(a, prep, s, seg_zero_state())[0])
    warm_secs = time.perf_counter() - t0
    compiled = clock.since(mark)
    t0 = time.perf_counter()
    state = seg_zero_state()
    for s in range(len(cfg["slabs"])):
        state = seg2_step(a, prep, s, state)
    lo, hi, checksum, truncated = (np.asarray(x) for x in state)
    secs = time.perf_counter() - t0
    nnz_c = int(lo) + (int(hi) << 16)
    if pool is not None:
        nnz_ref = sum(pool_job.get())
        pool.close()
        pool.join()
    else:
        nnz_ref = a2_nnz(csr)
    cs_ref = a2_checksum(csr)
    cs_err = abs(float(checksum) - cs_ref) / abs(cs_ref)
    # the sort each step kind compiled to (optimized HLO of one slab each)
    a2, _, b_rp, bounds, out_cap = prep
    sorts = {}
    for s in first.values():
        sl = cfg["slabs"][s]
        kind = "flat" if sl["flat"] else "window"
        if kind in sorts:
            continue
        st = seg_zero_state()
        if sl["flat"]:
            low = _seg2_flat_digest_step.lower(
                a2, a, b_rp, bounds, np.int32(s), *st, PLUS_TIMES,
                span_cap=sl["s_pad"], nnz_cap=sl["nnz_cap"],
                stream_cap=sl["flat_stream_cap"], slab_out_cap=out_cap)
        else:
            low = _seg2_slab_digest_step.lower(
                a2, a, b_rp, bounds, np.int32(s), np.int32(sl["cnt"]), *st,
                PLUS_TIMES, w=sl["w"], s_pad=sl["s_pad"],
                nnz_cap=sl["nnz_cap"], stream_cap=cfg["stream_cap"],
                slab_out_cap=out_cap)
        sorts[kind] = sort_impls(low.compile().as_text())
    ok = nnz_c == nnz_ref and not bool(truncated) and cs_err <= 1e-4
    return dict(
        phase="seg2_streamed_A2",
        input=dict(generator="rmat_ssca", scale=scale, edgefactor=8,
                   nnz_a=int(a.nnz)),
        flops=cfg["flops"], slabs=len(cfg["slabs"]), shapes=len(first),
        pad_ratio=cfg["pad_ratio"], plan_secs=plan_secs,
        warm_secs=warm_secs, secs=secs, **compiled,
        products_per_s=cfg["flops"] / secs, sorts=sorts, **_peak_bytes(),
        nnz_c=nnz_c, nnz_ref=nnz_ref, checksum=float(checksum),
        checksum_ref=cs_ref, checksum_rel_err=cs_err,
        reference="scipy row-block products (nnz exact); float64 "
                  "colsum.rowsum identity (rtol 1e-4, float32 per-slab sums)",
        truncated=bool(truncated), ok=bool(ok))


def _timed(clock, fn, *args, **kw):
    """(result, cold secs, warm secs, compile info) for one call repeated."""
    import jax

    mark = clock.mark()
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    cold = time.perf_counter() - t0
    compiled = clock.since(mark)
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, cold, time.perf_counter() - t0, compiled


def _csr_triples(csr):
    csr = csr.tocsr()
    csr.sort_indices()
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    return rows, csr.indices, csr.data


def _coo_matches(c_host, ref_csr, rtol: float) -> dict:
    """Structure exact (row-major sorted coordinates), values within rtol."""
    r, c, v = c_host
    rr, rc, rv = _csr_triples(ref_csr)
    same = (len(r) == len(rr) and np.array_equal(r, rr)
            and np.array_equal(c, rc))
    vals = same and np.allclose(np.asarray(v, np.float64), rv, rtol=rtol,
                                atol=0.0)
    return dict(nnz=int(len(r)), nnz_ref=int(len(rr)),
                structure_equal=bool(same), values_close=bool(vals))


def phase_spgemm(clock, seed: int, scale: int) -> dict:
    from combblas_tpu.ops.spgemm import spgemm_auto, spgemm_flops

    a = _graph500(seed, scale, 16, False)
    c, cold, warm, compiled = _timed(clock, spgemm_auto, a, a)
    ref = host_csr(*_coo_host(a), a.shape)
    cmp = _coo_matches(_coo_host(c), ref @ ref, rtol=1e-5)
    flops = spgemm_flops(a, a)
    return dict(
        phase="spgemm_auto_A2",
        input=dict(generator="rmat_g500", scale=scale, edgefactor=16,
                   nnz_a=int(a.nnz)),
        flops=flops, cold_secs=cold, secs=warm, **compiled,
        products_per_s=flops / warm, **_peak_bytes(), **cmp,
        reference="scipy A@A float64; structure exact, values rtol 1e-5 "
                  "(float32 sums in another order)",
        ok=cmp["structure_equal"] and cmp["values_close"])


def phase_bfs(clock, seed: int, scale: int, nroots: int = 64):
    from combblas_tpu.models.bfs import (
        bfs_batch_pull,
        bfs_dir_opt_local,
        bfs_local,
    )

    a = _graph500(seed, scale, 16, True)
    csr = host_csr(*_coo_host(a), a.shape)
    deg = np.diff(csr.indptr)
    roots = np.random.default_rng(seed).choice(
        np.flatnonzero(deg > 0), size=nroots, replace=False)
    (P, L), cold, warm, compiled = _timed(clock, bfs_batch_pull, a, roots)
    P, L = np.asarray(P), np.asarray(L)
    ref = bfs_levels_ref(csr, roots)
    keys = edge_keys(csr.indptr, csr.indices)
    n = a.shape[0]
    levels_ok = bool(np.array_equal(L, ref))
    parents_ok = all(validate_bfs_tree(keys, n, int(r), P[i], L[i])
                     for i, r in enumerate(roots))
    edges = [int(deg[L[i] >= 0].sum()) // 2 for i in range(nroots)]
    single = {}
    for name, fn in (("bfs_local", bfs_local),
                     ("bfs_dir_opt_local", bfs_dir_opt_local)):
        (p1, l1), c1, w1, comp1 = _timed(clock, fn, a, int(roots[0]))
        single[name] = dict(
            cold_secs=c1, secs=w1, **comp1,
            levels_equal=bool(np.array_equal(np.asarray(l1), ref[0])),
            parents_valid=validate_bfs_tree(keys, n, int(roots[0]), p1, l1))
    ok = levels_ok and parents_ok and all(
        s["levels_equal"] and s["parents_valid"] for s in single.values())
    return a, csr, dict(
        phase="bfs",
        input=dict(generator="rmat_g500_symmetric", scale=scale,
                   edgefactor=16, nnz=int(a.nnz), roots=nroots),
        batch_cold_secs=cold, batch_secs=warm, **compiled,
        traversed_edges=int(sum(edges)), teps=sum(edges) / warm,
        levels_equal=levels_ok, parents_valid=parents_ok, single=single,
        **_peak_bytes(),
        reference="scipy.sparse.csgraph unweighted shortest paths (exact); "
                  "Graph500 parent checks",
        ok=bool(ok))


def phase_cc(clock, a, csr) -> dict:
    from scipy.sparse.csgraph import connected_components

    from combblas_tpu.models.cc import fastsv_local
    from combblas_tpu.models.lacc import lacc_local

    ncomp, ref = connected_components(csr, directed=False)
    out = dict(phase="cc", input=dict(nnz=int(a.nnz), n=a.shape[0]),
               components_ref=int(ncomp))
    ok = True
    for name, fn in (("fastsv_local", fastsv_local),
                     ("lacc_local", lacc_local)):
        lab, cold, warm, compiled = _timed(clock, fn, a)
        eq = same_partition(np.asarray(lab), ref)
        out[name] = dict(cold_secs=cold, secs=warm, **compiled,
                         partition_equal=eq)
        ok &= eq
    out.update(_peak_bytes(), reference="scipy connected_components",
               ok=bool(ok))
    return out


def phase_mcl(clock, seed: int, ssca_scale: int = 14,
              blocks: int = 64) -> dict:
    import jax.numpy as jnp

    from combblas_tpu.models.mcl import MCLParams, mcl_local
    from combblas_tpu.ops.coo import SpCOO
    from combblas_tpu.ops.reduce import reduce_dim

    rows, cols, block = planted_partition(seed, blocks)
    n = len(block)
    a = SpCOO.from_arrays(rows, cols, np.ones(len(rows), np.float32), (n, n))
    # recover_num=0: mcl_local's recovery rule restores every column with
    # fewer than 0.9 * min(recover_num, select) entries, which at HipMCL's
    # defaults undoes the cutoff prune on columns this small (ROADMAP)
    planted_params = MCLParams(recover_num=0)
    mark = clock.mark()
    t0 = time.perf_counter()
    labels, iters = mcl_local(a, planted_params)
    labels = np.asarray(labels)
    planted_secs = time.perf_counter() - t0
    planted_compiled = clock.since(mark)
    dense = np.asarray(a.to_dense())
    ref = dense_mcl_labels(dense)
    planted = dict(
        n=n, blocks=int(block.max()) + 1, recover_num=0, iters=int(iters),
        secs=planted_secs, **planted_compiled,
        equals_planted=same_partition(labels, block),
        equals_dense_mcl=same_partition(labels, ref))

    a0 = _graph500(21, ssca_scale, 8, True, SSCA)
    p = MCLParams(select=64, recover_num=80)
    chaos, iter_secs, dev = [], [], []

    def on_iter(it, ch, secs, m):
        chaos.append(ch)
        iter_secs.append(secs)
        colsum = reduce_dim(m, "col")
        dev.append(float(jnp.max(jnp.where(colsum > 0,
                                           jnp.abs(colsum - 1.0), 0.0))))

    mark = clock.mark()
    t0 = time.perf_counter()
    _, iters = mcl_local(a0, p, on_iter=on_iter)
    ssca = dict(
        scale=ssca_scale, edgefactor=8, nnz=int(a0.nnz), select=p.select,
        recover_num=p.recover_num, iters=int(iters),
        secs=time.perf_counter() - t0, **clock.since(mark),
        first_iter_secs=iter_secs[0], last_iter_secs=iter_secs[-1],
        converged=bool(chaos[-1] < p.eps),
        max_colsum_dev=max(dev))
    ok = (planted["equals_planted"] and planted["equals_dense_mcl"]
          and ssca["converged"] and ssca["max_colsum_dev"] <= 1e-5)
    return dict(phase="mcl", planted=planted, ssca=ssca, **_peak_bytes(),
                reference="planted blocks and dense numpy MCL (partitions "
                          "equal); column sums within 1e-5 of 1",
                ok=bool(ok))


def phase_spmm(clock, seed: int, scale: int, d: int = 128) -> dict:
    import jax

    from combblas_tpu.ops.spmv import spmm

    a = _graph500(seed, scale, 16, False)
    x = jax.random.uniform(jax.random.PRNGKey(seed + 1), (a.shape[1], d))
    y, cold, warm, compiled = _timed(clock, spmm, a, x)
    ref = host_csr(*_coo_host(a), a.shape) @ np.asarray(x, np.float64)
    err = np.abs(np.asarray(y, np.float64) - ref)
    ok = bool(np.all(err <= 1e-4 * np.abs(ref)))
    nnz = int(a.nnz)
    return dict(
        phase="spmm", input=dict(generator="rmat_g500", scale=scale,
                                 edgefactor=16, nnz=nnz, d=d),
        cold_secs=cold, secs=warm, **compiled,
        gather_bytes=nnz * d * 4, **_peak_bytes(),
        max_rel_err=float(np.max(err / np.maximum(np.abs(ref), 1e-30))),
        reference="scipy float64, rtol 1e-4 (float32 scatter-add order)",
        ok=ok)


def phase_four(clock, seed: int, scale: int = 15, scale3d: int = 14,
               bfs_scale: int = 18, blocks: int = 64) -> dict:
    """Distributed paths on a 2x2 grid of the first four devices, each
    against the same single-device call on the first device."""
    import jax

    from combblas_tpu.models.bfs import bfs_dist, bfs_local
    from combblas_tpu.models.cc import fastsv_dist, fastsv_local
    from combblas_tpu.models.mcl import MCLParams, mcl_dist, mcl_local
    from combblas_tpu.ops.coo import SpCOO
    from combblas_tpu.ops.spgemm import spgemm_auto
    from combblas_tpu.parallel.dist import DistSpMat
    from combblas_tpu.parallel.grid import ProcGrid
    from combblas_tpu.parallel.memefficient import mem_efficient_spgemm
    from combblas_tpu.parallel.rma import summa_spgemm_rma
    from combblas_tpu.parallel.summa import summa_bounds, summa_spgemm
    from combblas_tpu.parallel.summa3d import (
        Dist3DSpMat,
        summa3d_bounds,
        summa3d_spgemm,
    )

    devs = jax.devices()[:4]
    grid = ProcGrid.make(2, 2, devices=devs)
    out = dict(phase="four", devices=len(devs))
    ok = True

    def spread(x) -> bool:
        return len(x.sharding.device_set) == len(devs)

    def spgemm_check(name, c, ref_host, t0, mark):
        nonlocal ok
        jax.block_until_ready(c.val)
        secs = time.perf_counter() - t0
        r, cc, v = _coo_host(c.to_local())
        cmp = _coo_matches((r, cc, v), ref_host, rtol=1e-5)
        good = cmp["structure_equal"] and cmp["values_close"] and spread(
            c.val)
        out[name] = dict(secs=secs, **clock.since(mark), **cmp,
                         spread=spread(c.val), ok=good)
        ok &= good

    a = _graph500(seed, scale, 16, False)
    local = host_csr(*_coo_host(spgemm_auto(a, a)), a.shape)
    A = DistSpMat.from_local(a, grid)
    fc, oc = summa_bounds(A, A)
    for name, call in (
            ("summa_spgemm", lambda: summa_spgemm(A, A, flops_cap=fc,
                                                  out_capacity=oc)),
            ("summa_spgemm_rma", lambda: summa_spgemm_rma(
                A, A, stage_flops_cap=fc, out_capacity=oc)),
            ("mem_efficient_spgemm", lambda: mem_efficient_spgemm(
                A, A, phases=2))):
        mark, t0 = clock.mark(), time.perf_counter()
        spgemm_check(name, call(), local, t0, mark)

    a3 = _graph500(seed, scale3d, 16, False)
    local3 = host_csr(*_coo_host(spgemm_auto(a3, a3)), a3.shape)
    g3 = ProcGrid.make(1, 1, layers=4, devices=devs)
    mark, t0 = clock.mark(), time.perf_counter()
    x3 = Dist3DSpMat.from_dist2d(a3, g3, "col")
    y3 = Dist3DSpMat.from_dist2d(a3, g3, "row")
    fc3, oc3 = summa3d_bounds(x3, y3)
    spgemm_check("summa3d_spgemm", summa3d_spgemm(
        x3, y3, flops_cap=fc3, out_capacity=oc3), local3, t0, mark)
    out["summa3d_spgemm"]["input_scale"] = scale3d

    g = _graph500(seed, bfs_scale, 16, True)
    n = g.shape[0]
    G = DistSpMat.from_local(g, grid)
    root = int(np.flatnonzero(np.diff(np.asarray(g.row_ptr())) > 0)[0])
    _, lv_local = bfs_local(g, root)
    mark, t0 = clock.mark(), time.perf_counter()
    _, lv = bfs_dist(G, root)
    jax.block_until_ready(lv)
    eq = bool(np.array_equal(np.asarray(lv)[:n], np.asarray(lv_local)))
    out["bfs_dist"] = dict(secs=time.perf_counter() - t0,
                           **clock.since(mark), levels_equal=eq,
                           spread=spread(lv))
    ok &= eq and spread(lv)

    mark, t0 = clock.mark(), time.perf_counter()
    lab = fastsv_dist(G)
    jax.block_until_ready(lab)
    eq = same_partition(np.asarray(lab)[:n], np.asarray(fastsv_local(g)))
    out["fastsv_dist"] = dict(secs=time.perf_counter() - t0,
                              **clock.since(mark), partition_equal=eq,
                              spread=spread(lab))
    ok &= eq and spread(lab)

    rows, cols, block = planted_partition(seed, blocks)
    npl = len(block)
    pm = SpCOO.from_arrays(rows, cols, np.ones(len(rows), np.float32),
                           (npl, npl))
    params = MCLParams(recover_num=0)  # as in phase_mcl
    lab_local, _ = mcl_local(pm, params)
    mark, t0 = clock.mark(), time.perf_counter()
    lab, iters = mcl_dist(DistSpMat.from_local(pm, grid), params)
    eq = same_partition(np.asarray(lab)[:npl], np.asarray(lab_local))
    out["mcl_dist"] = dict(secs=time.perf_counter() - t0,
                           **clock.since(mark), iters=int(iters),
                           partition_equal=eq,
                           equals_planted=same_partition(
                               np.asarray(lab)[:npl], block))
    ok &= eq
    out["input"] = dict(spgemm=f"rmat_g500 scale {scale} ef16",
                        bfs_cc=f"rmat_g500 symmetric scale {bfs_scale} ef16",
                        mcl=f"planted {npl} vertices")
    out.update(_peak_bytes(), ok=bool(ok),
               reference="same single-device call on the first card; "
                         "structure exact, values rtol 1e-5")
    return out


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--scale", type=int, default=20,
                    help="R-MAT scale of the streamed A² phase")
    ap.add_argument("--four", action="store_true",
                    help="run the distributed paths on four GPUs, alone")
    args = ap.parse_args(argv)

    import jax

    from combblas_tpu.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    clock = CompileClock()
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec, default=float), flush=True)

    if args.four:
        emit(phase_four(clock, args.seed))
        count = 4
    else:
        emit(phase_seg2(clock, args.seed, args.scale,
                        workers=min(os.cpu_count() or 1, 16)))
        emit(phase_spgemm(clock, args.seed, 16))
        g, csr, rec = phase_bfs(clock, args.seed, 18)
        emit(rec)
        emit(phase_cc(clock, g, csr))
        del g, csr
        emit(phase_mcl(clock, args.seed))
        emit(phase_spmm(clock, args.seed, 16))
        count = len(devices)
    print(_nvidia_smi(), flush=True)
    if not all(r["ok"] for r in records):
        failed = [r["phase"] for r in records if not r["ok"]]
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
