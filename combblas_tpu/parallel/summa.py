"""Distributed 2D SpGEMM — the Sparse-SUMMA counterpart.

Re-design of the reference's SUMMA family (``Mult_AnXBn_Synch``
``ParFriends.h:1005``, ``DoubleBuff`` ``:799``, ``Overlap`` ``:1111``): the
reference runs √p BSP stages, each broadcasting one block of A along the
process row and one block of B along the process column, multiplying locally,
and k-way-merging the √p partial results (``MultiwayMerge.h:412``).

On a device mesh the memory-generous fast path collapses all stages into ONE
step: ``lax.all_gather`` A's row panel along axis 'c' and B's column panel
along axis 'r' (XLA hands both to the collective library), then run a single
local ESC multiply over the whole panel — the sort in ESC performs what the
stage-merge did, so the k-way merge disappears.  Communication volume is
identical to the sum of the reference's √p broadcasts; latency is one
collective instead of √p serialized BSP supersteps.

A memory-constrained *staged* variant (one panel block per step, psum-style
broadcast, incremental merge — the true analogue of Synch/MemEfficient) lives
in :func:`summa_spgemm_staged`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from combblas_tpu.ops.coo import sort_compress
from combblas_tpu.ops.spgemm import expand_products
from combblas_tpu.parallel.dist import DistSpMat, block_dims
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = [
    "summa_spgemm",
    "summa_flops",
    "summa_bounds",
    "summa_spgemm_auto",
]


def _panel_a(ar, ac, av, an, kb: int, k_sent: int):
    """Flatten an all-gathered (g, cap) stack of A blocks into one row-panel
    triple list with panel-global column ids.  Order is irrelevant for the
    expansion; only validity masks matter."""
    g, cap = ar.shape
    s_off = (jnp.arange(g, dtype=jnp.int32) * kb)[:, None]
    valid = jnp.arange(cap, dtype=jnp.int32)[None, :] < an[:, None]
    col = jnp.where(valid, ac + s_off, k_sent)
    return ar.ravel(), col.ravel(), av.ravel(), valid.ravel()


def _panel_b_rp(br, bn, kb: int):
    """Row ranges of a gathered (g, cap) stack of B blocks, as rp_lo/rp_hi into
    the flattened (g*cap) panel buffers.  Block s's entries occupy
    [s*cap, s*cap + nnz_s) and are row-sorted locally, so the range for global
    row r = s*kb + lr is searchsorted within block s, offset by s*cap."""
    g, cap = br.shape

    def one(br_s, bn_s):
        rp = jnp.searchsorted(br_s, jnp.arange(kb + 1, dtype=jnp.int32)).astype(
            jnp.int32
        )
        return jnp.minimum(rp, bn_s)

    rp = jax.vmap(one)(br, bn)  # (g, kb+1)
    off = (jnp.arange(g, dtype=jnp.int32) * cap)[:, None]
    rp_lo = (rp[:, :-1] + off).ravel()
    rp_hi = (rp[:, 1:] + off).ravel()
    return rp_lo, rp_hi


def _summa_local(
    ar, ac, av, an, br, bc, bv, bn,
    *, sr: Semiring, flops_cap: int, out_capacity: int,
    mb: int, nb: int, kb_a: int, kb_b: int,
):
    """Per-device body: gather panels, one local ESC multiply -> C block."""
    # A row panel: all blocks A(i, s) along mesh axis 'c'.
    ar_g = jax.lax.all_gather(ar.reshape(-1), "c")  # (pc, cap)
    ac_g = jax.lax.all_gather(ac.reshape(-1), "c")
    av_g = jax.lax.all_gather(av.reshape(-1), "c")
    an_g = jax.lax.all_gather(an.reshape(()), "c")
    # B column panel: all blocks B(s, j) along mesh axis 'r'.
    br_g = jax.lax.all_gather(br.reshape(-1), "r")  # (pr, cap)
    bc_g = jax.lax.all_gather(bc.reshape(-1), "r")
    bv_g = jax.lax.all_gather(bv.reshape(-1), "r")
    bn_g = jax.lax.all_gather(bn.reshape(()), "r")

    k_panel = br_g.shape[0] * kb_b
    pa_row, pa_col, pa_val, pa_valid = _panel_a(ar_g, ac_g, av_g, an_g, kb_a, k_panel)
    rp_lo, rp_hi = _panel_b_rp(br_g, bn_g, kb_b)
    i, j, v, total = expand_products(
        pa_row, pa_col, pa_val, pa_valid,
        bc_g.ravel(), bv_g.ravel(), rp_lo, rp_hi,
        sr, flops_cap, (mb, nb),
    )
    c = sort_compress(i, j, v, total, (mb, nb), sr=sr,
                      out_capacity=out_capacity)
    return (
        c.row.reshape(1, 1, -1),
        c.col.reshape(1, 1, -1),
        c.val.reshape(1, 1, -1),
        c.nnz.reshape(1, 1),
    )


@functools.partial(
    jax.jit,
    static_argnames=("sr", "flops_cap", "out_capacity"),
)
def summa_spgemm(
    a: DistSpMat,
    b: DistSpMat,
    sr: Semiring = PLUS_TIMES,
    *,
    flops_cap: int,
    out_capacity: int,
) -> DistSpMat:
    """C = A ·_sr B on the 2D grid.  ``flops_cap`` must bound the *per-device*
    panel product count (see :func:`summa_bounds`)."""
    assert a.grid == b.grid, "operands on different grids (GRIDMISMATCH)"
    assert a.gshape[1] == b.gshape[0], "inner dimension mismatch (DIMMISMATCH)"
    grid = a.grid
    assert grid.pr == grid.pc, "SpGEMM needs a square grid (reference: √p×√p)"
    mb, kb_a = block_dims(a.gshape, grid)
    kb_b, nb = block_dims(b.gshape, grid)
    spec = P("r", "c", None)
    nspec = P("r", "c")
    fn = functools.partial(
        _summa_local,
        sr=sr, flops_cap=flops_cap, out_capacity=out_capacity,
        mb=mb, nb=nb, kb_a=kb_a, kb_b=kb_b,
    )
    crow, ccol, cval, cnnz = shard_map(
        fn,
        mesh=grid.mesh,
        in_specs=(spec, spec, spec, nspec) * 2,
        out_specs=(spec, spec, spec, nspec),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, b.row, b.col, b.val, b.nnz)
    return DistSpMat(
        row=crow, col=ccol, val=cval, nnz=cnnz,
        gshape=(a.gshape[0], b.gshape[1]), grid=grid,
    )


def _summa_flops_local(ar, ac, av, an, br, bc, bv, bn, *, kb_a, kb_b):
    br_g = jax.lax.all_gather(br.reshape(-1), "r")
    bn_g = jax.lax.all_gather(bn.reshape(()), "r")
    ar_g = jax.lax.all_gather(ar.reshape(-1), "c")
    ac_g = jax.lax.all_gather(ac.reshape(-1), "c")
    av_g = jax.lax.all_gather(av.reshape(-1), "c")
    an_g = jax.lax.all_gather(an.reshape(()), "c")
    k_panel = br_g.shape[0] * kb_b
    _, pa_col, _, pa_valid = _panel_a(ar_g, ac_g, av_g, an_g, kb_a, k_panel)
    rp_lo, rp_hi = _panel_b_rp(br_g, bn_g, kb_b)
    acol = jnp.minimum(pa_col, k_panel - 1)
    cnt = jnp.where(pa_valid, rp_hi[acol] - rp_lo[acol], 0)
    return jnp.sum(cnt).reshape(1, 1)


@jax.jit
def summa_flops(a: DistSpMat, b: DistSpMat) -> jax.Array:
    """(pr, pc) per-device product counts — the distributed symbolic pass
    (reference ``EstimateFLOP`` ``ParFriends.h:356``)."""
    grid = a.grid
    mb, kb_a = block_dims(a.gshape, grid)
    kb_b, nb = block_dims(b.gshape, grid)
    spec = P("r", "c", None)
    nspec = P("r", "c")
    fn = functools.partial(_summa_flops_local, kb_a=kb_a, kb_b=kb_b)
    return shard_map(
        fn,
        mesh=grid.mesh,
        in_specs=(spec, spec, spec, nspec) * 2,
        out_specs=nspec,
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, b.row, b.col, b.val, b.nnz)


def summa_bounds(a: DistSpMat, b: DistSpMat) -> Tuple[int, int]:
    """Host-side (flops_cap, out_capacity) for :func:`summa_spgemm`: max
    per-device panel flops, rounded to a 1/8-pow2 step."""
    from combblas_tpu.ops.spgemm import round_capacity_frac

    flops = int(jnp.max(summa_flops(a, b)))
    cap = round_capacity_frac(flops)
    return cap, cap


def summa_spgemm_auto(
    a: DistSpMat,
    b: DistSpMat,
    sr: Semiring = PLUS_TIMES,
    *,
    nnz_estimate: int | None = None,
) -> DistSpMat:
    """Host-driven SUMMA with estimate-and-retry output sizing.

    Mirrors :func:`combblas_tpu.ops.spgemm.spgemm_auto` for the distributed
    path: the per-block output buffer starts from an estimate (caller's, or
    half the panel flop bound) and the multiply retries with a doubled buffer
    whenever ANY block saturates (block nnz == capacity means compression may
    have truncated — the reference sizes exactly via its symbolic pass,
    ``estimateNNZ_Hash`` ``mtSpGEMM.h:807``; saturate-detect-retry is the
    static-shape equivalent)."""
    from combblas_tpu.ops.spgemm import round_capacity_frac

    flops_cap, oc = summa_bounds(a, b)
    if nnz_estimate is not None:
        out_cap = round_capacity_frac(max(int(nnz_estimate), 8))
    else:
        out_cap = round_capacity_frac(max(flops_cap // 2, 8))
    out_cap = min(out_cap, oc)
    while True:
        c = summa_spgemm(a, b, sr, flops_cap=flops_cap, out_capacity=out_cap)
        cap_actual = c.row.shape[-1]
        full = int(jnp.max(c.nnz)) >= min(out_cap, cap_actual)
        if not full or out_cap >= oc:
            return c
        out_cap = min(round_capacity_frac(out_cap * 2), oc)
