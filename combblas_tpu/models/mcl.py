"""MCL / HipMCL — Markov clustering via the expand–prune–inflate loop.

Counterpart of ``Applications/MCL.cpp`` (``HipMCL`` at ``:515``:
``while (chaos > EPS)`` of memory-efficient SpGEMM expansion ``:574``, column
pruning ``MCLPruneRecoverySelect`` ``ParFriends.h:186``, ``Inflate`` ``:447``,
``MakeColStochastic`` ``:390``, ``Chaos`` ``:408``; cluster extraction
``Interpret`` ``:373`` via connected components).

The loop runs on the host (capacities change between iterations — the same
reason the reference re-estimates phases per iteration); each stage is a jitted
kernel.  Pruning keeps the reference's semantics: entries below ``cutoff`` are
dropped, then if a column still has more than ``select`` entries only its
``select`` largest survive (recovery of columns pruned too hard uses
``recover_num``/``recover_pct`` analogously).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO, merge
from combblas_tpu.ops.ewise import apply_values, dim_apply, prune, prune_column
from combblas_tpu.ops.kselect import select_top_k_per_col
from combblas_tpu.ops.reduce import reduce_dim
from combblas_tpu.ops.spgemm import spgemm_auto
from combblas_tpu.models.cc import count_components, fastsv_local
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = [
    "MCLParams",
    "mcl_local",
    "mcl_dist",
    "make_col_stochastic",
    "chaos",
]


@dataclasses.dataclass
class MCLParams:
    """Mirrors HipMCL's runtime parameters (``MCL.cpp:233-371`` ProcessParam)."""

    inflation: float = 2.0
    cutoff: float = 1.0e-4  # prunelimit base
    select: int = 1100  # -select
    recover_num: int = 1400  # -recover_num
    recover_pct: float = 0.9  # -recover_pct
    eps: float = 1.0e-3  # chaos convergence EPS
    max_iters: int = 100
    add_self_loops: bool = True


def make_col_stochastic(a: SpCOO) -> SpCOO:
    """Normalize columns to sum 1 (``MakeColStochastic``, ``MCL.cpp:390`` —
    Reduce(Column,+) -> Apply(safemultinv) -> DimApply)."""
    colsum = reduce_dim(a, "col")
    inv = jnp.where(colsum > 0, 1.0 / colsum, 0.0)  # safemultinv (Operations.h:103)
    return dim_apply(a, inv, "col")


def chaos(a: SpCOO) -> jax.Array:
    """Convergence metric (``Chaos``, ``MCL.cpp:408``): max over columns of
    (column max - column 2-norm²), scaled by column nnz=... reference uses
    colmax - sum(sq)/1 — we match: max_j (max_i A_ij - Σ_i A_ij²)."""
    from combblas_tpu.semiring import MAX_FIRST

    colmax = reduce_dim(a, "col", MAX_FIRST)
    colmax = jnp.where(jnp.isfinite(colmax), colmax, 0.0)
    colss = reduce_dim(a, "col", premap=_square)
    return jnp.max(colmax - colss)


def _square(v):
    return v * v


def _inflate(a: SpCOO, power: float) -> SpCOO:
    val = jnp.where(a.mask(), jnp.power(jnp.abs(a.val), power), 0.0)
    return dataclasses.replace(a, val=val)


def _mcl_prune(a: SpCOO, p: MCLParams, out_capacity: int) -> SpCOO:
    """Threshold + select + recovery (``MCLPruneRecoverySelect``,
    ``ParFriends.h:186``) in ONE fused pass: a single (col, -|v|) sort
    yields per-column descending ranks; threshold/select/recover are then
    rank masks and the survivors compact once.  (The round-4 version
    chained prune -> kselect -> nnz-count -> kselect -> two masked merges
    — six capacity-sized sorted passes over five dispatches, vs one pass
    here.)"""
    return _mcl_prune_jit(
        a, cutoff=float(p.cutoff), select=int(p.select),
        recover_num=int(p.recover_num), recover_pct=float(p.recover_pct),
        out_capacity=int(out_capacity))


@functools.partial(
    jax.jit, static_argnames=("cutoff", "select", "recover_num",
                              "recover_pct", "out_capacity"))
def _mcl_prune_jit(a: SpCOO, *, cutoff: float, select: int,
                   recover_num: int, recover_pct: float,
                   out_capacity: int) -> SpCOO:
    from combblas_tpu.ops.ewise import _compact

    n = a.shape[1]
    cap = a.capacity
    live = a.mask()
    av = jnp.where(live, jnp.abs(a.val), -1.0)
    col = jnp.where(live, a.col, n)
    eid = jnp.arange(cap, dtype=jnp.int32)
    col_s, negv_s, eid_s = jax.lax.sort(
        (col, jnp.where(live, -av, jnp.inf), eid), num_keys=2)
    col_start = jnp.searchsorted(
        col_s, jnp.arange(n + 1, dtype=jnp.int32)).astype(jnp.int32)
    pos = jnp.arange(cap, dtype=jnp.int32) - col_start[
        jnp.minimum(col_s, n)]
    # entries >= cutoff form a per-column prefix of this order, so the
    # per-column kept count is a cumsum boundary difference (no scatter)
    cut_s = (-negv_s) >= cutoff
    c0 = jnp.concatenate([
        jnp.zeros((1,), jnp.int32), jnp.cumsum(cut_s.astype(jnp.int32))])
    kept = jnp.minimum(c0[col_start[1:]] - c0[col_start[:-1]], select)
    # recovery: columns whose post-select nnz fell below the floor take
    # their top recover_num from the UNPRUNED matrix (ParFriends.h:290)
    need_rec = kept < jnp.int32(recover_pct * min(recover_num, select))
    rec_s = need_rec[jnp.minimum(col_s, n - 1)]
    final_s = jnp.where(rec_s, pos < recover_num,
                        cut_s & (pos < select)) & (col_s < n)
    keep = jnp.zeros((cap,), jnp.bool_).at[eid_s].set(final_s)
    return _compact(a, keep, out_capacity)


def _mask_cols(a: SpCOO, colmask: jax.Array) -> SpCOO:
    from combblas_tpu.ops.ewise import _compact

    n = a.shape[1]
    keep = colmask[jnp.minimum(a.col, n - 1)]
    return _compact(a, keep)


def mcl_local(
    a: SpCOO,
    params: Optional[MCLParams] = None,
    verbose: bool = False,
    on_iter: Optional[Callable[[int, float, float], None]] = None,
    deadline: Optional[float] = None,
):
    """Run MCL on a local matrix; returns (cluster_labels, n_iterations).

    Clusters are the connected components of the converged matrix's structure
    (``Interpret``, ``MCL.cpp:373``).

    ``on_iter(it, chaos, secs, a)`` is called after every iteration with
    the normalized iterate ``a`` (bench and smoke-test hook); ``deadline``
    is an absolute ``time.perf_counter()`` cutoff — the loop stops early
    (labels still computed from the current matrix).
    """
    import time as _time
    p = params or MCLParams()
    n = a.shape[1]
    if p.add_self_loops:
        # AdjustLoops (MCL.cpp:464) — O(n) sparse identity, never a dense
        # (n, n) materialization
        a = merge(a, SpCOO.eye(n, dtype=a.val.dtype), PLUS_TIMES)
    a = make_col_stochastic(a)
    cap = max(a.capacity, 1 << int(np.ceil(np.log2(max(min(p.select * n, n * n), 8)))))
    it = 0
    # steady-state discipline: all capacities freeze after the
    # first expansion — the spgemm plan dict pins the compiled pipeline, the
    # pruned matrix always carries `cap`, so iterations 3+ reuse compiled
    # steps exactly (iteration 1 sees the original capacity, iteration 2
    # the frozen one).
    exp_plan: dict = {}
    for it in range(1, p.max_iters + 1):
        t0 = _time.perf_counter()
        # 2^28 slab budget: the default 2^24 forces the host-paced
        # row-chunked path (4+ dispatches/iter) at bench scales
        a2 = spgemm_auto(a, a, out_capacity=None, plan=exp_plan,
                         max_flops_cap=1 << 28)  # expansion
        a2 = _mcl_prune(a2, p, min(cap, a2.capacity))
        a2 = _inflate(a2, p.inflation)  # inflation
        a2 = make_col_stochastic(a2)
        ch = float(chaos(a2))
        a = a2
        if verbose:
            print(f"mcl iter {it}: chaos={ch:.5f} nnz={int(a.nnz)}")
        if on_iter is not None:
            on_iter(it, ch, _time.perf_counter() - t0, a)
        if ch < p.eps:
            break
        # never stop before iteration 3: the first two iterations carry
        # the two compile generations (original + frozen capacities), so
        # a steady-state sample needs at least one later iteration
        if deadline is not None and it >= 3 \
                and _time.perf_counter() > deadline:
            break
    # Interpret: clusters = weakly-connected components of final structure.
    sym = merge(a, a.transpose(), PLUS_TIMES)
    labels = fastsv_local(sym)
    return labels, it


def dist_mcl_prune(c, p: MCLParams, use_kselect2: bool = False):
    """Distributed ``MCLPruneRecoverySelect`` (``ParFriends.h:186``), matching
    the reference's single per-column threshold construction:

    1. stats from the hard-threshold-pruned matrix (entries <= cutoff drop);
    2. *recovery* columns (pruned nnz < recover_num, pruning actually removed
       something, and pruned column sum < recover_pct) take threshold =
       Kselect(A, recover_num);
    3. remaining columns with pruned nnz > select take threshold =
       Kselect(A, select);
    4. recovery-after-select (``ParFriends.h:290-330``): selected columns
       whose post-selection nnz < recover_num and sum < recover_pct fall back
       to Kselect(A, recover_num);
    5. one final PruneColumn(v < threshold) on the original matrix.

    ``use_kselect2`` switches the per-column selection to the bisection
    Kselect2 (``SpParMat.cpp:130``; safe on unpruned matrices)."""
    import jax.numpy as jnp

    from combblas_tpu.parallel.elementwise import (
        dist_kselect2_col,
        dist_kselect_col,
        dist_nnz_per_col,
        dist_prune,
        dist_prune_column,
        dist_reduce,
    )

    if use_kselect2:
        ksel = dist_kselect2_col
    else:
        # Kselect1 with the reference's <=k-candidate shipping
        # (SpParMat.cpp:1191): k is static here (MCL params), so the
        # gather-along-'r' carries at most k candidates per column
        kmax = max(int(p.recover_num), int(p.select), 1)
        ksel = lambda c_, k_: dist_kselect_col(c_, k_, k_cap=kmax)
    c1 = dist_prune(c, _below_or_equal_cutoff(p.cutoff))
    nnz_unpruned = dist_nnz_per_col(c)
    nnz_p = dist_nnz_per_col(c1)
    sums = dist_reduce(c1, "col")
    thresh = jnp.full_like(sums, p.cutoff)
    recover = (
        (nnz_p < p.recover_num) & (nnz_unpruned > nnz_p)
        & (sums < p.recover_pct)
    )
    if p.recover_num > 0 and bool(jnp.any(recover)):
        th_r = ksel(c, p.recover_num)
        thresh = jnp.where(recover, th_r, thresh)
    if p.select > 0:
        sel = (~recover) & (nnz_p > p.select)
        if bool(jnp.any(sel)):
            th_s = ksel(c, p.select)
            thresh = jnp.where(sel, th_s, thresh)
            if p.recover_num > 0:
                c_sel = dist_prune_column(c, thresh, _below_thresh)
                nnz1 = dist_nnz_per_col(c_sel)
                sums1 = dist_reduce(c_sel, "col")
                resel = sel & (nnz1 < p.recover_num) & (sums1 < p.recover_pct)
                if bool(jnp.any(resel)):
                    th_rs = ksel(c, p.recover_num)
                    thresh = jnp.where(resel, th_rs, thresh)
    return dist_prune_column(c, thresh, _below_thresh)


def dist_remove_isolated(a):
    """``RemoveIsolated`` (``MCL.cpp:477``): drop empty columns/rows by
    compacting the kept vertices to the front of the index space (one
    owner-exchange permutation instead of the reference's SpRef).  Returns
    (compacted matrix, keep_map host array with -1 for dropped, n_keep)."""
    import numpy as np

    from combblas_tpu.parallel.elementwise import dist_nnz_per_col
    from combblas_tpu.parallel.indexing import dist_permute

    n = a.gshape[1]
    colnnz = np.asarray(dist_nnz_per_col(a))[:n]
    keep = colnnz > 0
    n_keep = int(keep.sum())
    rank = np.cumsum(keep) - 1
    vmap = np.where(keep, rank, -1).astype(np.int32)
    return dist_permute(a, vmap, vmap), vmap, n_keep


def dist_rand_permute(a, key):
    """``RandPermute`` (``MCL.cpp:497``): symmetric random relabeling
    A(p, p) — mesh-wide threefry RandPerm + one owner-exchange."""
    import numpy as np

    from combblas_tpu.parallel.indexing import dist_permute
    from combblas_tpu.parallel.vector import dist_rand_perm

    n = a.gshape[1]
    perm = np.asarray(dist_rand_perm(key, n, a.grid))[:n]
    return dist_permute(a, perm), perm


def mcl_dist(a, params: Optional[MCLParams] = None, phases: int = 1,
             verbose: bool = False, preprocess: bool = False,
             rng_key=None, use_kselect2: bool = False,
             layers: int = 1, grid3=None):
    """Distributed HipMCL (``MCL.cpp:515`` with ``MemEfficientSpGEMM`` at
    ``:574``): the expansion runs as (optionally phased) SUMMA on the 2D mesh
    with the prune/select/recover hook applied INSIDE each phase (the point of
    phasing — ``ParFriends.h:698``), pruning/normalization as distributed
    column ops, convergence via the distributed chaos metric, and Interpret as
    distributed FastSV.  ``preprocess=True`` runs RemoveIsolated + RandPermute
    (``MCL.cpp:477-497``) first and translates labels back.

    ``layers > 1`` switches the expansion to the 3D path — the reference's
    ``MCL.cpp:577`` layer switch to ``MemEfficientSpGEMM3D``: each iteration
    redistributes A to the 3D grid (``grid3``; SpParMat3D ctor), runs
    phased layer-local SUMMA + fiber reduction per column slab, converts
    each slab product back to the 2D grid (``Convert2D``) and applies the
    SAME per-phase prune/select/recover hook before accumulating.  The 2D<->
    3D redistributions are host-paced, like the reference's MPI tuple
    alltoallv.

    ``a``: DistSpMat on a square grid.  Returns (labels, iterations)."""
    import jax.numpy as jnp

    from combblas_tpu.models.cc import fastsv_dist
    from combblas_tpu.parallel.dist import DistSpMat
    from combblas_tpu.parallel.elementwise import (
        dist_add,
        dist_apply,
        dist_dim_apply,
        dist_reduce,
        dist_transpose,
    )
    from combblas_tpu.parallel.memefficient import mem_efficient_spgemm
    from combblas_tpu.semiring import MAX_FIRST

    p = params or MCLParams()

    vmap = None
    n_orig = a.gshape[1]
    if preprocess:
        import numpy as np

        a, vmap, n_keep = dist_remove_isolated(a)
        a, perm = dist_rand_permute(
            a, rng_key if rng_key is not None else jax.random.PRNGKey(17)
        )
        # composite vertex map: original -> permuted-compacted
        vmap = np.where(vmap >= 0, perm[np.maximum(vmap, 0)], -1)

    def col_stochastic(m: DistSpMat) -> DistSpMat:
        colsum = dist_reduce(m, "col")
        inv = jnp.where(colsum > 0, 1.0 / colsum, 0.0)
        return dist_dim_apply(m, inv, "col")

    def dist_chaos(m: DistSpMat):
        cmax = dist_reduce(m, "col", MAX_FIRST)
        cmax = jnp.where(jnp.isfinite(cmax), cmax, 0.0)
        css = dist_reduce(m, "col", premap=_square)
        return jnp.max(cmax - css)

    def prune_hook(c: DistSpMat) -> DistSpMat:
        return dist_mcl_prune(c, p, use_kselect2=use_kselect2)

    if layers > 1:
        assert grid3 is not None and grid3.is3d and grid3.layers == layers, \
            "mcl_dist(layers>1) needs a 3D ProcGrid (grid3=)"

        def expand(m: DistSpMat) -> DistSpMat:
            from combblas_tpu.parallel.summa3d import (
                Dist3DSpMat,
                _col_slab3d,
                summa3d_bounds,
                summa3d_spgemm,
            )

            a3 = Dist3DSpMat.from_dist2d(m, grid3, "col")
            b3 = Dist3DSpMat.from_dist2d(m, grid3, "row")
            fc, oc = summa3d_bounds(a3, b3)
            fc = max(fc // max(phases, 1), 1024)
            oc = max(oc // max(phases, 1), 1024)
            _, nb3 = b3.block_shape()
            slab = -(-nb3 // phases)
            acc = None
            for ph in range(phases):
                lo, hi = ph * slab, min((ph + 1) * slab, nb3)
                if lo >= hi:
                    break
                bp = _col_slab3d(b3, lo, hi) if phases > 1 else b3
                cp3 = summa3d_spgemm(a3, bp, flops_cap=fc, out_capacity=oc)
                cp = prune_hook(cp3.to_dist2d(m.grid))
                acc = cp if acc is None else dist_add(
                    acc, cp, out_capacity=acc.capacity + cp.capacity)
            return acc
    else:
        def expand(m: DistSpMat) -> DistSpMat:
            return mem_efficient_spgemm(m, m, phases=phases,
                                        phase_hook=prune_hook)

    a = col_stochastic(a)
    it = 0
    for it in range(1, p.max_iters + 1):
        # per-phase pruning: each phase's column slab is pruned before the
        # next phase runs, so peak memory is one pruned slab (the entire
        # reason MemEfficientSpGEMM phases — ParFriends.h:698).
        a2 = expand(a)
        a2 = dist_apply(a2, _pow_closure(p.inflation))
        a2 = col_stochastic(a2)
        ch = float(dist_chaos(a2))
        a = a2
        if verbose:
            print(f"mcl_dist iter {it}: chaos={ch:.5f} "
                  f"nnz={int(a.total_nnz())}")
        if ch < p.eps:
            break
    sym = dist_add(a, dist_transpose(a))
    labels = fastsv_dist(sym)
    if vmap is not None:
        import numpy as np

        lab = np.asarray(labels)
        out = np.empty((n_orig,), lab.dtype)
        kept = vmap >= 0
        out[kept] = lab[vmap[kept]]
        # isolated vertices are their own singleton clusters, labeled
        # disjointly from the kept range
        out[~kept] = a.gshape[1] + np.nonzero(~kept)[0]
        return out, it
    return labels, it


def _below_cutoff(cutoff: float):
    def f(v):
        return jnp.abs(v) < cutoff

    return f


def _below_or_equal_cutoff(cutoff: float):
    # the reference's hard-threshold prune is less_equal (ParFriends.h:197)
    def f(v):
        return v <= cutoff

    return f


def _below_thresh(v, t):
    return v < t


def _pow_closure(power: float):
    def f(v):
        return jnp.power(jnp.abs(v), power)

    return f
