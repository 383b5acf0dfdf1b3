"""Memory-constrained distributed SpGEMM: staged SUMMA and phased (MCL) path.

Counterparts of the reference's memory-bounded multiply family:

- :func:`summa_spgemm_staged` — the true analogue of ``Mult_AnXBn_Synch``
  (``ParFriends.h:1005``): one block-panel broadcast per stage (expressed as a
  masked psum over the mesh axis — bandwidth-equivalent to MPI_Bcast on a
  ring), local multiply into a per-stage buffer, and an incremental sorted
  merge into the running accumulator (replacing the end-of-run k-way
  ``MultiwayMerge``).  Peak memory: one stage panel + 2x output, vs the
  all-gather SUMMA's full-panel expansion.

- :func:`mem_efficient_spgemm` — ``MemEfficientSpGEMM`` (``ParFriends.h:450``):
  B is processed in column slabs (``ColSplit(phases, ...)``), each slab
  multiplied with the full A and optionally pruned (MCL's
  prune/select/recover hook) before the next slab starts, so the full product
  never materializes.  Phase count from a per-device memory budget
  (``CalculateNumberOfPhases``, ``ParFriends.h:733``).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from combblas_tpu.ops.coo import SpCOO, compress_sorted, sort_compress
from combblas_tpu.ops.spgemm import expand_products
from combblas_tpu.parallel.dist import DistSpMat, block_dims
from combblas_tpu.parallel.summa import summa_bounds, summa_spgemm, summa_flops
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = ["summa_spgemm_staged", "mem_efficient_spgemm",
           "calculate_phases", "block_spgemm"]

_SPEC = P("r", "c", None)
_NSPEC = P("r", "c")


def _bcast(x, axis: str, src_index):
    """Broadcast from the device whose axis-index == src_index (masked psum —
    the collective the reference gets from ``SpParHelper::BCastMatrix``)."""
    me = jax.lax.axis_index(axis)
    return jax.lax.psum(jnp.where(me == src_index, x, jnp.zeros_like(x)), axis)


def _staged_local(
    ar, ac, av, an, br, bc, bv, bn,
    *, sr, stage_flops_cap, out_capacity, mb, nb, kb_a, kb_b, stages,
):
    cap_a = ar.reshape(-1).shape[0]
    cap_b = br.reshape(-1).shape[0]
    ar_, ac_, av_ = ar.reshape(-1), ac.reshape(-1), av.reshape(-1)
    br_, bc_, bv_ = br.reshape(-1), bc.reshape(-1), bv.reshape(-1)
    an_, bn_ = an.reshape(()), bn.reshape(())

    acc_row0 = jnp.full((out_capacity,), mb, jnp.int32)
    acc_col0 = jnp.full((out_capacity,), nb, jnp.int32)
    acc_val0 = jnp.zeros((out_capacity,), av_.dtype)
    acc_nnz0 = jnp.asarray(0, jnp.int32)

    def stage(s, carry):
        acc_row, acc_col, acc_val, acc_nnz = carry
        # panel broadcasts: A(i,s) along 'c', B(s,j) along 'r'
        par = _bcast(ar_, "c", s)
        pac = _bcast(ac_, "c", s)
        pav = _bcast(av_, "c", s)
        pan = _bcast(an_, "c", s)
        pbr = _bcast(br_, "r", s)
        pbc = _bcast(bc_, "r", s)
        pbv = _bcast(bv_, "r", s)
        pbn = _bcast(bn_, "r", s)
        # local multiply: A-block (mb, kb_a) x B-block (kb_b, nb)
        rp = jnp.searchsorted(pbr, jnp.arange(kb_b + 1, dtype=jnp.int32)).astype(
            jnp.int32
        )
        rp = jnp.minimum(rp, pbn)
        a_valid = jnp.arange(cap_a, dtype=jnp.int32) < pan
        i, j, v, total = expand_products(
            par, pac, pav, a_valid, pbc, pbv, rp[:-1], rp[1:],
            sr, stage_flops_cap, (mb, nb),
        )
        cs = sort_compress(i, j, v, total, (mb, nb), sr=sr,
                           out_capacity=stage_flops_cap)
        # incremental merge into the accumulator
        mrow = jnp.concatenate([acc_row, cs.row])
        mcol = jnp.concatenate([acc_col, cs.col])
        mval = jnp.concatenate([acc_val, cs.val])
        mrow, mcol, mval = jax.lax.sort((mrow, mcol, mval), num_keys=2)
        merged = compress_sorted(
            mrow, mcol, mval, acc_nnz + cs.nnz, (mb, nb), sr=sr,
            out_capacity=out_capacity,
        )
        return merged.row, merged.col, merged.val, merged.nnz

    acc = jax.lax.fori_loop(
        0, stages, stage, (acc_row0, acc_col0, acc_val0, acc_nnz0)
    )
    acc_row, acc_col, acc_val, acc_nnz = acc
    return (
        acc_row.reshape(1, 1, -1),
        acc_col.reshape(1, 1, -1),
        acc_val.reshape(1, 1, -1),
        acc_nnz.reshape(1, 1),
    )


@functools.partial(
    jax.jit, static_argnames=("sr", "stage_flops_cap", "out_capacity")
)
def summa_spgemm_staged(
    a: DistSpMat,
    b: DistSpMat,
    sr: Semiring = PLUS_TIMES,
    *,
    stage_flops_cap: int,
    out_capacity: int,
) -> DistSpMat:
    """Stage-looped SUMMA with per-stage panel broadcasts and incremental
    merge — bounded peak memory (``Mult_AnXBn_Synch`` semantics)."""
    assert a.grid == b.grid and a.gshape[1] == b.gshape[0]
    grid = a.grid
    assert grid.pr == grid.pc, "SUMMA needs a square grid"
    mb, kb_a = block_dims(a.gshape, grid)
    kb_b, nb = block_dims(b.gshape, grid)
    fn = functools.partial(
        _staged_local,
        sr=sr, stage_flops_cap=stage_flops_cap, out_capacity=out_capacity,
        mb=mb, nb=nb, kb_a=kb_a, kb_b=kb_b, stages=grid.pc,
    )
    crow, ccol, cval, cnnz = shard_map(
        fn,
        mesh=grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC) * 2,
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, b.row, b.col, b.val, b.nnz)
    return DistSpMat(row=crow, col=ccol, val=cval, nnz=cnnz,
                     gshape=(a.gshape[0], b.gshape[1]), grid=grid)


def calculate_phases(
    a: DistSpMat, b: DistSpMat, per_device_mem_bytes: float,
    bytes_per_product: int = 24, est_c_nnz: float | None = None,
) -> int:
    """Phase count from the memory model (``CalculateNumberOfPhases``,
    ``ParFriends.h:733``): smallest p such that the per-phase expansion
    PLUS the accumulated output fits the per-device budget.  The output
    term uses ``est_c_nnz`` when given (the Cohen sampling estimate — the
    reference's ``EstPerProcessNnzSpMV`` path, ``ParFriends.h:2810,3215``),
    so sizing costs 2R SpMVs instead of forming the product symbolically."""
    flops = int(jnp.max(summa_flops(a, b)))
    need = flops * bytes_per_product
    if est_c_nnz is not None:
        # accumulated C is resident across phases: 12 bytes/entry (row,
        # col, val), spread over the grid
        per_dev_out = est_c_nnz * 12 / max(a.grid.pr * a.grid.pc, 1)
        avail = max(per_device_mem_bytes - per_dev_out,
                    per_device_mem_bytes * 0.25)
        return max(1, int(np.ceil(need / max(avail, 1.0))))
    return max(1, int(np.ceil(need / max(per_device_mem_bytes, 1.0))))


@jax.jit
def _col_slab_counts(b: DistSpMat, bounds: jax.Array) -> jax.Array:
    """Per-(phase, block) slab entry counts for column-slab phasing:
    counts[p, i, j] = nnz of block (i,j) with col in [bounds[p], bounds[p+1]).
    One sort per block + a searchsorted over the phase bounds — O(capacity)
    peak memory regardless of phase count (the memory-bounding path must not
    itself allocate a (phases, capacity) intermediate)."""
    idx = jnp.arange(b.capacity, dtype=jnp.int32)[None, None, :]
    c = jnp.where(idx < b.nnz[..., None], b.col, jnp.iinfo(jnp.int32).max)
    c = jnp.sort(c, axis=-1)
    pos = jax.vmap(jax.vmap(lambda cc: jnp.searchsorted(cc, bounds)))(c)
    return jnp.moveaxis(pos[..., 1:] - pos[..., :-1], -1, 0).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("lo", "hi", "slab_cap"))
def _col_slab(b: DistSpMat, lo: int, hi: int,
              slab_cap: int | None = None) -> DistSpMat:
    """B's block-local columns [lo, hi), PHYSICALLY repacked to ``slab_cap``
    entries per block — the reference's ``ColSplit`` (``ParFriends.h:553``)
    splits storage, so each phase's panel broadcast moves ~1/phases of B,
    not a full-capacity masked copy.  Without ``slab_cap`` the full capacity
    is kept (sentinel masking only)."""
    import dataclasses

    mb, nb = block_dims(b.gshape, b.grid)
    inside = (b.col >= lo) & (b.col < hi)
    cap = b.capacity
    idx = jnp.arange(cap, dtype=jnp.int32)[None, None, :]
    valid = (idx < b.nnz[..., None]) & inside
    row = jnp.where(valid, b.row, mb)
    col = jnp.where(valid, b.col, nb)
    val = jnp.where(valid, b.val, 0)
    # resort each block so slab entries form a sorted prefix, then truncate
    # the trailing all-sentinel tail to the static slab capacity
    row, col, val = jax.lax.sort((row, col, val), dimension=-1, num_keys=2)
    nnz = jnp.sum(valid, axis=-1).astype(jnp.int32)
    if slab_cap is not None and slab_cap < cap:
        row = row[..., :slab_cap]
        col = col[..., :slab_cap]
        val = val[..., :slab_cap]
        nnz = jnp.minimum(nnz, slab_cap)  # caller sized slab_cap >= counts
    return dataclasses.replace(b, row=row, col=col, val=val, nnz=nnz)


def mem_efficient_spgemm(
    a: DistSpMat,
    b: DistSpMat,
    sr: Semiring = PLUS_TIMES,
    phases: int | None = None,
    per_device_mem_bytes: float = 2e9,
    phase_hook: Callable[[DistSpMat], DistSpMat] | None = None,
    out_capacity: int | None = None,
) -> DistSpMat:
    """Phased SpGEMM over column slabs of B (``MemEfficientSpGEMM``,
    ``ParFriends.h:450``).  ``phase_hook`` is applied to each phase's slab
    product before accumulation — MCL passes its prune/select/recover there
    (``MCLPruneRecoverySelect``, ``ParFriends.h:186``).  Host-driven phase
    loop; each phase is one jitted SUMMA."""
    from combblas_tpu.ops.spgemm import round_capacity_frac
    from combblas_tpu.parallel.elementwise import dist_add

    grid = a.grid
    mb, nb = block_dims(b.gshape, grid)
    if phases is None:
        # size phases from the Cohen sampling estimate of nnz(C) — the
        # estimator on the hot path, as the reference's 3D memory split
        # does (``ParFriends.h:3215``); exact flops remain the expansion
        # term, the estimate prices the resident accumulated output
        from combblas_tpu.parallel.spmv import est_nnz_spgemm_sampling

        est_c = est_nnz_spgemm_sampling(a, b, jax.random.PRNGKey(0))
        phases = calculate_phases(a, b, per_device_mem_bytes,
                                  est_c_nnz=est_c)
    phases = min(phases, nb)
    slab = -(-nb // phases)
    bounds = np.minimum(np.arange(phases + 1, dtype=np.int32) * slab, nb)
    # one device pass sizes every phase's physical slab (ColSplit splits
    # storage; a phase's panel gather must move ~1/phases of B's bytes)
    counts = np.asarray(_col_slab_counts(b, jnp.asarray(bounds)))
    acc = None
    for p in range(phases):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        if lo >= hi:
            break
        slab_cap = min(
            round_capacity_frac(max(int(counts[p].max()), 8)), b.capacity)
        bp = _col_slab(b, lo, hi, slab_cap)
        fc, oc = summa_bounds(a, bp)
        cp = summa_spgemm(a, bp, sr, flops_cap=fc, out_capacity=oc)
        if phase_hook is not None:
            cp = phase_hook(cp)
        acc = cp if acc is None else dist_add(
            acc, cp, out_capacity=out_capacity or (acc.capacity + cp.capacity)
        )
    return acc


@functools.partial(jax.jit, static_argnames=("lo", "hi", "slab_cap"))
def _row_slab(a: DistSpMat, lo: int, hi: int,
              slab_cap: int | None = None) -> DistSpMat:
    """A's block-local rows [lo, hi), physically repacked — the row-wise
    twin of :func:`_col_slab` (``SpParMat::BlockSplit`` row direction,
    ``SpParMat.cpp:2974``)."""
    import dataclasses

    mb, nb = block_dims(a.gshape, a.grid)
    inside = (a.row >= lo) & (a.row < hi)
    cap = a.capacity
    idx = jnp.arange(cap, dtype=jnp.int32)[None, None, :]
    valid = (idx < a.nnz[..., None]) & inside
    row = jnp.where(valid, a.row, mb)
    col = jnp.where(valid, a.col, nb)
    val = jnp.where(valid, a.val, 0)
    row, col, val = jax.lax.sort((row, col, val), dimension=-1, num_keys=2)
    nnz = jnp.sum(valid, axis=-1).astype(jnp.int32)
    if slab_cap is not None and slab_cap < cap:
        row = row[..., :slab_cap]
        col = col[..., :slab_cap]
        val = val[..., :slab_cap]
        nnz = jnp.minimum(nnz, slab_cap)
    return dataclasses.replace(a, row=row, col=col, val=val, nnz=nnz)


@jax.jit
def _row_slab_counts(a: DistSpMat, bounds: jax.Array) -> jax.Array:
    """Row-direction twin of :func:`_col_slab_counts` (sort + searchsorted,
    O(capacity) peak memory)."""
    idx = jnp.arange(a.capacity, dtype=jnp.int32)[None, None, :]
    r = jnp.where(idx < a.nnz[..., None], a.row, jnp.iinfo(jnp.int32).max)
    r = jnp.sort(r, axis=-1)
    pos = jax.vmap(jax.vmap(lambda rr: jnp.searchsorted(rr, bounds)))(r)
    return jnp.moveaxis(pos[..., 1:] - pos[..., :-1], -1, 0).astype(jnp.int32)


def block_spgemm(a: DistSpMat, b: DistSpMat, br: int, bc: int,
                 sr: Semiring = PLUS_TIMES):
    """C-grid block iterator — ``BlockSpGEMM`` (``BlockSpGEMM.h:16``):
    yields ``((i, j), C_ij)`` for the br x bc grid of C blocks, each the
    product of A's i-th row strip with B's j-th column strip, computed one
    at a time so only one C block is ever resident (the reference multiplies
    each with ``Mult_AnXBn_DoubleBuff``; ours runs the auto SUMMA).

    Strips are BLOCK-LOCAL ranges (each device splits its local block
    br/bc ways), so a strip is the same 1/br (resp. 1/bc) share of every
    device's rows — the same per-block partitioning ``BlockSplit`` performs,
    expressed in the 2D-cyclic frame; C_ij rides the full grid with only
    its strip populated, and the per-device row range is ``(i*rs,
    min((i+1)*rs, mb))``."""
    from combblas_tpu.ops.spgemm import round_capacity_frac
    from combblas_tpu.parallel.summa import summa_spgemm_auto

    mb, _ = block_dims(a.gshape, a.grid)
    _, nb = block_dims(b.gshape, b.grid)
    rs, cs = -(-mb // br), -(-nb // bc)
    rbounds = np.minimum(np.arange(br + 1, dtype=np.int32) * rs, mb)
    cbounds = np.minimum(np.arange(bc + 1, dtype=np.int32) * cs, nb)
    rcounts = np.asarray(_row_slab_counts(a, jnp.asarray(rbounds)))
    ccounts = np.asarray(_col_slab_counts(b, jnp.asarray(cbounds)))
    for i in range(br):
        rlo, rhi = int(rbounds[i]), int(rbounds[i + 1])
        if rlo >= rhi:
            continue
        rcap = min(round_capacity_frac(max(int(rcounts[i].max()), 8)),
                   a.capacity)
        ap = _row_slab(a, rlo, rhi, rcap)
        for j in range(bc):
            clo, chi = int(cbounds[j]), int(cbounds[j + 1])
            if clo >= chi:
                continue
            ccap = min(round_capacity_frac(max(int(ccounts[j].max()), 8)),
                       b.capacity)
            bp = _col_slab(b, clo, chi, ccap)
            yield (i, j), summa_spgemm_auto(ap, bp, sr)
