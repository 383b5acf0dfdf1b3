"""Distributed elementwise ops, reductions, transpose, and k-select.

Counterparts of the remaining ``SpParMat`` method surface:
``Apply``/``Prune``/``PruneI`` (``SpParMat.cpp:2567``), ``EWiseMult``/
``SetDifference`` (``:2781-2817``), ``DimApply`` (``:801``), ``Reduce``
(``:888-961``), ``Transpose`` (``:3528``), ``Kselect1`` (``:1191``) and
``PruneColumn`` (``:2567``).

Structure-local ops (apply/prune/ewise between aligned matrices) are
embarrassingly parallel over blocks — one ``shard_map`` with no collectives.
Dimension ops (DimApply/Reduce/Kselect/PruneColumn) reuse the SpMV fan-out/
fan-in collectives: gather the vector slice along the orthogonal mesh axis,
reduce partial results with the semiring collective.  Transpose swaps local
coordinates under shard_map and then swaps the block-grid axes — XLA lowers
the stacked-array transpose to the same pairwise exchange the reference does
with complement ranks.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from combblas_tpu.ops import ewise as lew
from combblas_tpu.ops import kselect as lks
from combblas_tpu.ops.coo import SpCOO, sort_coo
from combblas_tpu.parallel.dist import DistSpMat, block_dims
from combblas_tpu.parallel.spmv import _axis_reduce
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = [
    "dist_apply",
    "dist_prune",
    "dist_ewise_mult",
    "dist_add",
    "dist_dim_apply",
    "dist_prune_column",
    "dist_reduce",
    "dist_kselect_col",
    "dist_kselect2_col",
    "dist_kselect_col_checked",
    "dist_transpose",
    "dist_nnz_per_col",
]

_SPEC = P("r", "c", None)
_NSPEC = P("r", "c")


def _blk(row, col, val, nnz, shape) -> SpCOO:
    return SpCOO(
        row=row.reshape(-1),
        col=col.reshape(-1),
        val=val.reshape(-1),
        nnz=nnz.reshape(()),
        shape=shape,
    )


def _unblk(c: SpCOO):
    return (
        c.row.reshape(1, 1, -1),
        c.col.reshape(1, 1, -1),
        c.val.reshape(1, 1, -1),
        c.nnz.reshape(1, 1),
    )


def _blockwise(a: DistSpMat, body, out_gshape=None, extra=()):
    """Run a local SpCOO -> SpCOO function on every block, no communication."""
    bs = block_dims(a.gshape, a.grid)

    def f(row, col, val, nnz, *ex):
        c = body(_blk(row, col, val, nnz, bs), *ex)
        return _unblk(c)

    crow, ccol, cval, cnnz = shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC) + tuple(P() for _ in extra),
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, *extra)
    return DistSpMat(
        row=crow, col=ccol, val=cval, nnz=cnnz,
        gshape=out_gshape or a.gshape, grid=a.grid,
    )


@functools.partial(jax.jit, static_argnames=("fn",))
def dist_apply(a: DistSpMat, fn: Callable) -> DistSpMat:
    return _blockwise(a, lambda blk: lew.apply_values(blk, fn))


@functools.partial(jax.jit, static_argnames=("pred",))
def dist_prune(a: DistSpMat, pred: Callable) -> DistSpMat:
    return _blockwise(a, lambda blk: lew.prune(blk, pred))


@functools.partial(jax.jit, static_argnames=("exclude", "out_capacity"))
def dist_ewise_mult(
    a: DistSpMat, b: DistSpMat, exclude: bool = False,
    out_capacity: int | None = None,
) -> DistSpMat:
    assert a.grid == b.grid and a.gshape == b.gshape
    bs = block_dims(a.gshape, a.grid)
    cap = out_capacity or max(a.capacity, b.capacity)

    def f(ar, ac, av, an, br, bc, bv, bn):
        c = lew.ewise_mult(
            _blk(ar, ac, av, an, bs), _blk(br, bc, bv, bn, bs),
            exclude=exclude, out_capacity=cap,
        )
        return _unblk(c)

    crow, ccol, cval, cnnz = shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC) * 2,
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, b.row, b.col, b.val, b.nnz)
    return DistSpMat(row=crow, col=ccol, val=cval, nnz=cnnz,
                     gshape=a.gshape, grid=a.grid)


@functools.partial(jax.jit, static_argnames=("out_capacity",))
def dist_add(a: DistSpMat, b: DistSpMat, out_capacity: int | None = None) -> DistSpMat:
    assert a.grid == b.grid and a.gshape == b.gshape
    bs = block_dims(a.gshape, a.grid)
    cap = out_capacity or (a.capacity + b.capacity)

    def f(ar, ac, av, an, br, bc, bv, bn):
        c = lew.add(
            _blk(ar, ac, av, an, bs), _blk(br, bc, bv, bn, bs), out_capacity=cap
        )
        return _unblk(c)

    crow, ccol, cval, cnnz = shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC) * 2,
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, b.row, b.col, b.val, b.nnz)
    return DistSpMat(row=crow, col=ccol, val=cval, nnz=cnnz,
                     gshape=a.gshape, grid=a.grid)


@functools.partial(jax.jit, static_argnames=("dim", "fn"))
def dist_dim_apply(
    a: DistSpMat, x: jax.Array, dim: str, fn: Callable = jnp.multiply
) -> DistSpMat:
    """A_ij = fn(A_ij, x_i or x_j); x in the matching FullyDist layout
    (row-space P(('r','c')) for dim='row', col-space P(('c','r')) for 'col')."""
    mb, nb = block_dims(a.gshape, a.grid)
    in_len = a.grid.pr * mb if dim == "row" else a.grid.pc * nb
    kx = min(x.shape[0], in_len)
    xp = jnp.zeros((in_len,), x.dtype).at[:kx].set(x[:kx])
    vec_spec = P(("r", "c")) if dim == "row" else P(("c", "r"))
    gather_ax = "c" if dim == "row" else "r"

    def f(row, col, val, nnz, x_loc):
        x_blk = jax.lax.all_gather(x_loc, gather_ax, tiled=True)
        c = lew.dim_apply(_blk(row, col, val, nnz, (mb, nb)), x_blk, dim, fn)
        return _unblk(c)

    crow, ccol, cval, cnnz = shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, vec_spec),
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, xp)
    return DistSpMat(row=crow, col=ccol, val=cval, nnz=cnnz,
                     gshape=a.gshape, grid=a.grid)


@functools.partial(jax.jit, static_argnames=("pred",))
def dist_prune_column(a: DistSpMat, x: jax.Array, pred: Callable) -> DistSpMat:
    """Drop entry (i,j) when pred(A_ij, x_j); x in col-space layout."""
    mb, nb = block_dims(a.gshape, a.grid)
    in_len = a.grid.pc * nb
    kx = min(x.shape[0], in_len)
    xp = jnp.zeros((in_len,), x.dtype).at[:kx].set(x[:kx])

    def f(row, col, val, nnz, x_loc):
        x_blk = jax.lax.all_gather(x_loc, "r", tiled=True)
        c = lew.prune_column(_blk(row, col, val, nnz, (mb, nb)), x_blk, pred)
        return _unblk(c)

    crow, ccol, cval, cnnz = shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, P(("c", "r"))),
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, xp)
    return DistSpMat(row=crow, col=ccol, val=cval, nnz=cnnz,
                     gshape=a.gshape, grid=a.grid)


@functools.partial(jax.jit, static_argnames=("dim", "sr", "premap"))
def dist_reduce(
    a: DistSpMat, dim: str, sr: Semiring = PLUS_TIMES,
    premap: Callable | None = None,
) -> jax.Array:
    """Row ('row') or column ('col') reduction -> FullyDist vector
    (row-space P(('r','c')) / col-space P(('c','r')) layout respectively)."""
    from combblas_tpu.ops.reduce import reduce_dim
    from combblas_tpu.parallel.spmv import _axis_reduce_scatter

    mb, nb = block_dims(a.gshape, a.grid)

    def f(row, col, val, nnz):
        part = reduce_dim(_blk(row, col, val, nnz, (mb, nb)), dim, sr, premap)
        red_ax = "c" if dim == "row" else "r"
        return _axis_reduce_scatter(part, red_ax, sr)

    out_spec = P(("r", "c")) if dim == "row" else P(("c", "r"))
    return shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        out_specs=out_spec,
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz)


@jax.jit
def dist_nnz_per_col(a: DistSpMat) -> jax.Array:
    """Per-column stored-entry counts, col-space layout (int32)."""
    from combblas_tpu.parallel.spmv import _axis_reduce_scatter
    from combblas_tpu.semiring import PLUS_TIMES as PT

    mb, nb = block_dims(a.gshape, a.grid)

    def f(row, col, val, nnz):
        from combblas_tpu.ops.reduce import nnz_per

        part = nnz_per(_blk(row, col, val, nnz, (mb, nb)), "col")
        return _axis_reduce_scatter(part, "r", PT)

    return shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        out_specs=P(("c", "r")),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz)


def dist_kselect_col(a: DistSpMat, k, k_cap: int | None = None,
                     full_gather: bool = False) -> jax.Array:
    """Per-column k-th largest value (1-indexed), -inf where fewer than k
    entries — Kselect1 (``SpParMat.cpp:1191``).

    When ``k`` is a static Python int and no ``k_cap`` is given, ``k``
    itself becomes the candidate cap — callers never silently fall into the
    full-capacity gather.  The unbounded gather (O(pr * cap) per device) is
    an explicit opt-in via ``full_gather=True`` (needed only when k is a
    traced per-column vector with no static bound)."""
    if k_cap is None and not full_gather:
        if isinstance(k, (int, np.integer)):
            k_cap = int(k)
        else:
            raise ValueError(
                "dist_kselect_col: traced k needs a static k_cap (candidate "
                "bound) or an explicit full_gather=True opt-in — the "
                "unbounded path gathers full block capacity along 'r' "
                "(round-1 memory hazard)")
    return _dist_kselect_col(a, k, k_cap)


@functools.partial(jax.jit, static_argnames=("k_cap",))
def _dist_kselect_col(a: DistSpMat, k: jax.Array,
                      k_cap: int | None = None) -> jax.Array:
    """Kselect1 core.  With ``k_cap`` (a static upper bound on k — MCL's
    select parameter), each block first reduces every column to its LOCAL
    top-k_cap candidates and only those are gathered along mesh axis 'r' —
    the reference's ≤k-candidates-per-column shipping,
    O(pr * min(cap, nb*k_cap)) per device instead of O(pr * cap).  Without
    it the full pruned blocks are gathered.  k: scalar or col-space vector
    (per-column k supported).  Output col-space layout, replicated over
    'r'."""
    mb, nb = block_dims(a.gshape, a.grid)
    pr, pc = a.grid.pr, a.grid.pc
    k_len = pc * nb
    k = jnp.broadcast_to(jnp.asarray(k, jnp.int32), (k_len,))
    cap = a.row.shape[-1]
    cand_cap = cap
    if k_cap is not None:
        from combblas_tpu.ops.spgemm import round_capacity_frac

        k = jnp.minimum(k, k_cap)  # candidates beyond k_cap are not shipped
        cand_cap = min(cap, round_capacity_frac(max(nb * int(k_cap), 128)))

    def f(row, col, val, nnz, k_loc):
        c = col.reshape(-1)
        v = val.reshape(-1)
        valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
        cc = jnp.where(valid, c, nb)
        vv = jnp.where(valid, v, 0.0)
        if k_cap is not None:
            # local top-k_cap per column: sort (col asc, val desc), rank
            # within the column run, keep rank < k_cap, compact left
            key_v = jax.lax.bitcast_convert_type(
                vv.astype(jnp.float32), jnp.uint32)
            key_v = jnp.where((key_v >> 31).astype(jnp.bool_), ~key_v,
                              key_v | jnp.uint32(0x80000000))
            sc, sk, sv = jax.lax.sort((cc, ~key_v, vv), num_keys=2)
            pos = jnp.arange(cap, dtype=jnp.int32)
            newc = jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), sc[1:] != sc[:-1]])
            start = jax.lax.cummax(jnp.where(newc, pos, 0))
            rank = pos - start
            keep = (sc < nb) & (rank < k_cap)
            dest = jnp.where(keep, jnp.cumsum(keep.astype(jnp.int32)) - 1,
                             cand_cap)
            ccand = jnp.full((cand_cap,), nb, jnp.int32).at[dest].set(
                sc, mode="drop")
            vcand = jnp.zeros((cand_cap,), vv.dtype).at[dest].set(
                sv, mode="drop")
            nncand = jnp.sum(keep.astype(jnp.int32))
        else:
            ccand, vcand, nncand = cc, vv, nnz.reshape(())
        # gather this block-column's candidates from all pr row-blocks
        col_g = jax.lax.all_gather(ccand, "r")  # (pr, cand_cap)
        val_g = jax.lax.all_gather(vcand, "r")
        nnz_g = jax.lax.all_gather(nncand, "r")
        gvalid = (jnp.arange(cand_cap, dtype=jnp.int32)[None, :]
                  < nnz_g[:, None])
        cols = jnp.where(gvalid, col_g, nb).ravel()
        vals = jnp.where(gvalid, val_g, 0.0).ravel()
        # entries are unsorted across blocks; kselect's validity handling
        # needs sentinels (col == nb) at the end, so sort by col first.
        order_col, order_val = jax.lax.sort((cols, vals), num_keys=1)
        stacked = SpCOO(
            row=jnp.zeros_like(order_col), col=order_col, val=order_val,
            nnz=jnp.sum(nnz_g), shape=(1, nb),
        )
        k_blk = jax.lax.all_gather(k_loc, "r", tiled=True)  # (nb,)
        return lks.kselect_col(stacked, k_blk)

    return shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, P(("c", "r"))),
        out_specs=P("c"),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, k)


@jax.jit
def dist_kselect2_col(a: DistSpMat, k: jax.Array) -> jax.Array:
    """Per-column k-th largest by iterative value-space bisection — the
    Kselect2 counterpart (``SpParMat.cpp:130,309``: iterative median pruning
    with TopKGather).  The reference narrows candidates by shipping medians;
    here the same narrowing runs as 32 rounds of bisection on the
    order-preserving uint32 image of the values: each round counts, per
    column, entries >= mid (one masked segment-sum + one psum along 'r') and
    halves the feasible interval.  Memory is O(ncols) per device — unlike
    Kselect1's candidate gather, this never materializes the column entries,
    so it stays safe on unpruned matrices (the reference's reason for having
    both).  k: scalar or col-space vector; -inf where a column has < k
    entries (or k <= 0).  Output col-space layout, replicated over 'r'."""
    mb, nb = block_dims(a.gshape, a.grid)
    pc = a.grid.pc
    k_len = pc * nb
    k = jnp.broadcast_to(jnp.asarray(k, jnp.int32), (k_len,))

    def f(row, col, val, nnz, k_loc):
        cap = col.reshape(-1).shape[0]
        c = col.reshape(-1)
        v = val.reshape(-1)
        valid = jnp.arange(cap, dtype=jnp.int32) < nnz.reshape(())
        cc = jnp.where(valid, c, nb)
        # order-preserving uint32 image (floats: flip sign bit / complement)
        b = jax.lax.bitcast_convert_type(v.astype(jnp.float32), jnp.uint32)
        u = jnp.where(
            (b >> 31).astype(jnp.bool_), ~b, b | jnp.uint32(0x80000000)
        )
        k_blk = jax.lax.all_gather(k_loc, "r", tiled=True)  # (nb,)

        def count_ge(thresh):
            ge = valid & (u >= thresh[jnp.minimum(cc, nb - 1)])
            cnt = jax.ops.segment_sum(
                ge.astype(jnp.int32), cc, num_segments=nb + 1
            )[:nb]
            return jax.lax.psum(cnt, "r")

        total = count_ge(jnp.zeros((nb,), jnp.uint32))
        found = (total >= k_blk) & (k_blk > 0)

        def body(_, lohi):
            lo, hi = lohi  # invariant: feasible(lo), not feasible(hi + 1)
            mid = lo + (hi - lo) // 2 + (hi - lo) % 2  # upper mid, uint32-safe
            feas = count_ge(mid) >= k_blk
            lo = jnp.where(feas, mid, lo)
            hi = jnp.where(feas, hi, mid - 1)
            return lo, hi

        lo0 = jnp.zeros((nb,), jnp.uint32)
        hi0 = jnp.full((nb,), 0xFFFFFFFF, jnp.uint32)
        lo, _ = jax.lax.fori_loop(0, 32, body, (lo0, hi0))
        # invert the order-preserving map
        top = (lo >> 31).astype(jnp.bool_)
        bits = jnp.where(top, lo & jnp.uint32(0x7FFFFFFF), ~lo)
        vals = jax.lax.bitcast_convert_type(bits, jnp.float32)
        return jnp.where(found, vals, -jnp.inf)

    return shard_map(
        f,
        mesh=a.grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC, P(("c", "r"))),
        out_specs=P("c"),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, k)


def dist_kselect_col_checked(a: DistSpMat, k,
                             k_cap: int | None = None) -> jax.Array:
    """Run Kselect1 (candidate gather) and Kselect2 (bisection) and assert
    they agree — the reference's cross-validation wrappers
    (``SpParMat.cpp:1120,1160``)."""
    if k_cap is None and not isinstance(k, (int, np.integer)):
        k_cap = int(np.max(np.asarray(k)))  # static bound from concrete k
    v1 = dist_kselect_col(a, k, k_cap=k_cap)
    v2 = dist_kselect2_col(a, k)
    a1, a2 = jnp.asarray(v1), jnp.asarray(v2)
    ok = jnp.all((a1 == a2) | (jnp.isneginf(a1) & jnp.isneginf(a2)))
    if not bool(ok):
        raise AssertionError("Kselect1/Kselect2 disagree (KSELECTLIMITERROR)")
    return v1


@jax.jit
def dist_transpose(a: DistSpMat) -> DistSpMat:
    """Aᵀ on a square grid: local coordinate swap + block-grid axis swap.

    The block swap (pr, pc, cap) -> (pc, pr, cap) under the P('r','c',None)
    sharding is the all-to-all pair exchange of ``SpParMat::Transpose``
    (``SpParMat.cpp:3528``), emitted by XLA from a plain transpose."""
    grid = a.grid
    assert grid.pr == grid.pc, "transpose needs a square grid (as the reference)"
    mb, nb = block_dims(a.gshape, grid)

    def f(row, col, val, nnz):
        blk = _blk(row, col, val, nnz, (mb, nb))
        t = blk.transpose()  # (nb, mb) local, re-sorted
        return _unblk(t)

    trow, tcol, tval, tnnz = shard_map(
        f,
        mesh=grid.mesh,
        in_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        out_specs=(_SPEC, _SPEC, _SPEC, _NSPEC),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz)
    # swap block coordinates: block (i, j) -> (j, i)
    sh = NamedSharding(grid.mesh, _SPEC)
    nsh = NamedSharding(grid.mesh, _NSPEC)
    return DistSpMat(
        row=jax.lax.with_sharding_constraint(jnp.swapaxes(trow, 0, 1), sh),
        col=jax.lax.with_sharding_constraint(jnp.swapaxes(tcol, 0, 1), sh),
        val=jax.lax.with_sharding_constraint(jnp.swapaxes(tval, 0, 1), sh),
        nnz=jax.lax.with_sharding_constraint(jnp.swapaxes(tnnz, 0, 1), nsh),
        gshape=(a.gshape[1], a.gshape[0]),
        grid=grid,
    )
