"""3D (split-layer, communication-avoiding) SpGEMM.

Counterpart of ``Mult_AnXBn_SUMMA3D`` (``ParFriends.h:2919-3208``),
``SpParMat3D`` (``SpParMat3D.cpp:187`` 2D->3D redistribution) and the
standalone ``3DSpGEMM/`` suite (``SUMMALayer.h``, ``Reductions.h:36`` —
per-layer SUMMA then an alltoall+multiway-merge reduction along the fiber).

Mesh: ('l', 'r', 'c').  The inner dimension k is split across layers: layer t
owns the k-range [t·k/l, (t+1)·k/l) of A's columns and B's rows.  Each layer
runs the all-gather SUMMA locally (collectives stay inside the layer — that is
the communication-avoiding point: row/col panel traffic shrinks by l while a
single fiber reduction is added), then partial C blocks are reduced along 'l'.

The fiber reduction is ONE all_to_all along 'l' over per-layer column ranges
(exactly ``Reductions.h:36``'s alltoall + merge): each layer groups its
partial C entries by destination column range (one local sort), exchanges
balanced-capacity chunks, and merges what it receives — 1/l the bytes of an
all_gather formulation.  Overfull chunks saturate the output nnz (the
caller's retry-with-bigger-buffers signal).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from combblas_tpu.ops.coo import SpCOO, compress_sorted, sort_compress
from combblas_tpu.ops.spgemm import expand_products
from combblas_tpu.parallel.dist import DistSpMat, block_dims
from combblas_tpu.parallel.grid import ProcGrid
from combblas_tpu.parallel.summa import _panel_a, _panel_b_rp
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = [
    "Dist3DSpMat",
    "summa3d_spgemm",
    "summa3d_bounds",
    "mem_efficient_spgemm3d",
]

_SPEC3 = P("l", "r", "c", None)
_NSPEC3 = P("l", "r", "c")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Dist3DSpMat:
    """Layer-split distributed sparse matrix: (l, pr, pc, cap) block stacks.

    ``split`` is the split dimension: 'col' (A operands — layer t holds the
    t-th column range) or 'row' (B operands).  Block-local coordinates are
    relative to the per-layer block shape.
    """

    row: jax.Array
    col: jax.Array
    val: jax.Array
    nnz: jax.Array  # (l, pr, pc)
    gshape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    grid: ProcGrid = dataclasses.field(metadata=dict(static=True))
    split: str = dataclasses.field(metadata=dict(static=True))

    @property
    def layers(self) -> int:
        return self.grid.layers

    def layer_shape(self) -> Tuple[int, int]:
        """Per-layer global (sub)matrix shape before 2D blocking."""
        m, n = self.gshape
        if self.split == "col":
            return m, -(-n // self.layers)
        if self.split == "row":
            return -(-m // self.layers), n
        # 'blockcol': layer t owns the t-th column slice of every 2D block
        # (the reference's CalculateColSplitDistributionOfLayer layout).
        mb, nb = block_dims(self.gshape, self.grid.grid2d())
        return self.grid.grid2d().pr * mb, nb // self.layers * self.grid.grid2d().pc

    def block_shape(self) -> Tuple[int, int]:
        g2 = self.grid.grid2d()
        if self.split == "blockcol":
            mb, nb = block_dims(self.gshape, g2)
            return mb, nb // self.layers
        return block_dims(self.layer_shape(), g2)

    @staticmethod
    def from_dist2d(a: "DistSpMat | SpCOO", grid: ProcGrid, split: str,
                    capacity: int | None = None) -> "Dist3DSpMat":
        """Host-side 2D->3D redistribution (``SpParMat3D.cpp:187``): slice the
        split dimension into l ranges, 2D-distribute each slice on the layer's
        grid, stack along 'l'."""
        assert grid.is3d
        from combblas_tpu.parallel.dist import DistSpMat as D2

        if isinstance(a, D2):
            a = a.to_local()
        nnz = int(a.nnz)
        row = np.asarray(a.row)[:nnz]
        col = np.asarray(a.col)[:nnz]
        val = np.asarray(a.val)[:nnz]
        m, n = a.shape
        l = grid.layers
        g2 = grid.grid2d()
        if split == "col":
            sb = -(-n // l)
            which = col // sb
            lr_, lc_ = row, col - which * sb
            lshape = (m, sb)
        else:
            sb = -(-m // l)
            which = row // sb
            lr_, lc_ = row - which * sb, col
            lshape = (sb, n)
        layers = []
        cap = 0
        for t in range(l):
            sel = which == t
            d2 = D2.from_coo_arrays(
                lr_[sel], lc_[sel], val[sel], lshape, g2, dtype=val.dtype
            )
            layers.append(d2)
            cap = max(cap, d2.capacity)
        cap = capacity or cap
        R = np.stack([_pad_np(np.asarray(d.row), cap, d.block_shape()[0])
                      for d in layers])
        C = np.stack([_pad_np(np.asarray(d.col), cap, d.block_shape()[1])
                      for d in layers])
        V = np.stack([_pad_np(np.asarray(d.val), cap, 0) for d in layers])
        N = np.stack([np.asarray(d.nnz) for d in layers])
        sh = NamedSharding(grid.mesh, _SPEC3)
        nsh = NamedSharding(grid.mesh, _NSPEC3)
        return Dist3DSpMat(
            row=jax.device_put(R, sh),
            col=jax.device_put(C, sh),
            val=jax.device_put(V, sh),
            nnz=jax.device_put(N, nsh),
            gshape=a.shape,
            grid=grid,
            split=split,
        )

    def to_local(self) -> SpCOO:
        """Gather to one host SpCOO (tests; the reference's Convert2D check)."""
        l = self.layers
        g2 = self.grid.grid2d()
        mb, nb = self.block_shape()
        R = np.asarray(self.row)
        C = np.asarray(self.col)
        V = np.asarray(self.val)
        N = np.asarray(self.nnz)
        m, n = self.gshape
        rows, cols, vals = [], [], []
        nb_full = block_dims(self.gshape, g2)[1] if self.split == "blockcol" else None
        for t in range(l):
            for i in range(g2.pr):
                for j in range(g2.pc):
                    k = int(N[t, i, j])
                    r = R[t, i, j, :k] + i * mb
                    if self.split == "blockcol":
                        c = C[t, i, j, :k] + j * nb_full + t * nb
                    elif self.split == "col":
                        c = C[t, i, j, :k] + j * nb + t * self.layer_shape()[1]
                    else:
                        c = C[t, i, j, :k] + j * nb
                        r = r + t * self.layer_shape()[0]
                    rows.append(r)
                    cols.append(c)
                    vals.append(V[t, i, j, :k])
        return SpCOO.from_arrays(
            np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
            (m, n), sum_duplicates=True,
        )

    def to_dist2d(self, grid2: ProcGrid) -> "DistSpMat":
        """3D -> 2D redistribution (``Convert2D``, ``SpParMat3D.cpp:441``):
        gather the layer stacks and re-bucket onto the 2D grid's owners.
        Host-paced, like the reference's tuple alltoallv through MPI."""
        from combblas_tpu.parallel.dist import DistSpMat as D2

        loc = self.to_local()
        nnz = int(loc.nnz)
        return D2.from_coo_arrays(
            np.asarray(loc.row)[:nnz], np.asarray(loc.col)[:nnz],
            np.asarray(loc.val)[:nnz], loc.shape, grid2,
            dtype=np.asarray(loc.val).dtype,
        )


def _pad_np(x, cap, fill):
    pr, pc, c0 = x.shape
    if c0 == cap:
        return x
    out = np.full((pr, pc, cap), fill, x.dtype)
    out[:, :, :c0] = x
    return out


def _summa3d_local(
    ar, ac, av, an, br, bc, bv, bn,
    *, sr, flops_cap, out_capacity, fiber_cap, mb, nb, kb_a, kb_b, nlayers,
):
    """Per-device body: layer-local SUMMA + fiber all_to_all reduction."""
    # layer-local panels (collectives on 'r'/'c' stay inside the layer)
    ar_g = jax.lax.all_gather(ar.reshape(-1), "c")
    ac_g = jax.lax.all_gather(ac.reshape(-1), "c")
    av_g = jax.lax.all_gather(av.reshape(-1), "c")
    an_g = jax.lax.all_gather(an.reshape(()), "c")
    br_g = jax.lax.all_gather(br.reshape(-1), "r")
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
    part = sort_compress(i, j, v, total, (mb, nb), sr=sr,
                         out_capacity=out_capacity)
    # ---- fiber reduction along 'l' via all_to_all (Reductions.h:36) ----
    # Each layer owns the column range [t*nb/l, (t+1)*nb/l) of every block
    # (CalculateColSplitDistributionOfLayer); partial entries are grouped by
    # destination layer and exchanged with ONE all_to_all — 1/l the bytes of
    # the previous all_gather formulation.  Per-pair capacity ``fiber_cap``
    # carries 2x-balanced slack; an overfull range saturates the output nnz
    # (the caller's retry signal) instead of silently dropping.
    nb_split = nb // nlayers
    live = jnp.arange(out_capacity, dtype=jnp.int32) < part.nnz
    dest = jnp.where(live, jnp.minimum(part.col // nb_split, nlayers - 1),
                     nlayers)
    d_s, r_s, c_s, v_s = jax.lax.sort(
        (dest, part.row, part.col, part.val), num_keys=1
    )
    ids = jnp.arange(nlayers, dtype=jnp.int32)
    starts = jnp.searchsorted(d_s, ids, side="left").astype(jnp.int32)
    lens = jnp.searchsorted(d_s, ids, side="right").astype(jnp.int32) - starts
    overfull = jnp.any(lens > fiber_cap)
    tt = jnp.arange(fiber_cap, dtype=jnp.int32)
    pos = jnp.minimum(starts[:, None] + tt[None, :], out_capacity - 1)
    ok = tt[None, :] < lens[:, None]
    sr_r = jnp.where(ok, r_s[pos], mb)
    sr_c = jnp.where(ok, c_s[pos], nb)
    sr_v = jnp.where(ok, v_s[pos], 0)
    rr = jax.lax.all_to_all(sr_r, "l", 0, 0)
    rc = jax.lax.all_to_all(sr_c, "l", 0, 0)
    rv = jax.lax.all_to_all(sr_v, "l", 0, 0)
    rlen = jax.lax.all_to_all(
        jnp.broadcast_to(jnp.minimum(lens, fiber_cap)[:, None],
                         (nlayers, 1)), "l", 0, 0,
    ).reshape(nlayers)
    over = jax.lax.pmax(overfull.astype(jnp.int32), "l") > 0
    t = jax.lax.axis_index("l")
    lo = t.astype(jnp.int32) * nb_split
    rok = tt[None, :] < rlen[:, None]
    rows = jnp.where(rok, rr, mb).ravel()
    cols = jnp.where(rok, rc - lo, nb_split).ravel()
    vals = jnp.where(rok, rv, 0).ravel()
    nvalid = jnp.sum(rlen)
    c = sort_compress(rows, cols, vals, nvalid, (mb, nb_split), sr=sr,
                      out_capacity=out_capacity)
    nnz_out = jnp.where(over, out_capacity, c.nnz).astype(jnp.int32)
    return (
        c.row.reshape(1, 1, 1, -1),
        c.col.reshape(1, 1, 1, -1),
        c.val.reshape(1, 1, 1, -1),
        nnz_out.reshape(1, 1, 1),
    )


@functools.partial(jax.jit, static_argnames=("sr", "flops_cap", "out_capacity"))
def summa3d_spgemm(
    a: Dist3DSpMat,
    b: Dist3DSpMat,
    sr: Semiring = PLUS_TIMES,
    *,
    flops_cap: int,
    out_capacity: int,
) -> Dist3DSpMat:
    """C = A ·_sr B with A col-split and B row-split across layers.

    Output is col-split across layers: layer t owns C's columns
    [t·nb/l, (t+1)·nb/l) of each block — the reference's layer column split
    (``SpParMat3D.cpp:576``)."""
    assert a.grid == b.grid and a.grid.is3d
    assert a.split == "col" and b.split == "row"
    grid = a.grid
    g2 = grid.grid2d()
    assert g2.pr == g2.pc
    mb, kb_a = a.block_shape()
    kb_b, nb = b.block_shape()
    l = grid.layers
    assert nb % l == 0, "column block must split evenly across layers"
    # per-destination-layer exchange capacity: balanced share + 2x slack
    fiber_cap = min(out_capacity,
                    max(-(-out_capacity // l) * 2, 2048))
    fn = functools.partial(
        _summa3d_local,
        sr=sr, flops_cap=flops_cap, out_capacity=out_capacity,
        fiber_cap=fiber_cap, mb=mb, nb=nb, kb_a=kb_a, kb_b=kb_b, nlayers=l,
    )
    crow, ccol, cval, cnnz = shard_map(
        fn,
        mesh=grid.mesh,
        in_specs=(_SPEC3, _SPEC3, _SPEC3, _NSPEC3) * 2,
        out_specs=(_SPEC3, _SPEC3, _SPEC3, _NSPEC3),
        check_vma=False,
    )(a.row, a.col, a.val, a.nnz, b.row, b.col, b.val, b.nnz)
    return Dist3DSpMat(
        row=crow, col=ccol, val=cval, nnz=cnnz,
        gshape=(a.gshape[0], b.gshape[1]), grid=grid, split="blockcol",
    )


def _col_slab3d(b: Dist3DSpMat, lo: int, hi: int) -> Dist3DSpMat:
    """Mask B3 to block-local columns [lo, hi) — ColSplit for the 3D phased
    path (entries outside become per-block sentinels, blocks re-sorted)."""
    mb, nb = b.block_shape()
    cap = b.row.shape[-1]
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = (idx < b.nnz[..., None]) & (b.col >= lo) & (b.col < hi)
    row = jnp.where(valid, b.row, mb)
    col = jnp.where(valid, b.col, nb)
    val = jnp.where(valid, b.val, 0)
    row, col, val = jax.lax.sort((row, col, val), dimension=-1, num_keys=2)
    return dataclasses.replace(
        b, row=row, col=col, val=val,
        nnz=jnp.sum(valid, axis=-1).astype(jnp.int32),
    )


def _concat3d(a: Dist3DSpMat, b: Dist3DSpMat) -> Dist3DSpMat:
    """Entrywise concat of two same-layout 3D matrices with disjoint columns
    (phase outputs), blocks re-sorted."""
    row = jnp.concatenate([a.row, b.row], axis=-1)
    col = jnp.concatenate([a.col, b.col], axis=-1)
    val = jnp.concatenate([a.val, b.val], axis=-1)
    row, col, val = jax.lax.sort((row, col, val), dimension=-1, num_keys=2)
    return dataclasses.replace(a, row=row, col=col, val=val, nnz=a.nnz + b.nnz)


def mem_efficient_spgemm3d(
    a: Dist3DSpMat,
    b: Dist3DSpMat,
    sr: Semiring = PLUS_TIMES,
    phases: int = 1,
    flops_cap: int | None = None,
    out_capacity: int | None = None,
    phase_hook=None,
) -> Dist3DSpMat:
    """Phased 3D SpGEMM (``MemEfficientSpGEMM3D``, ``ParFriends.h:3215``):
    column slabs of B per phase, each slab through the layer-local SUMMA +
    fiber reduction, outputs concatenated (disjoint column ranges).
    ``phase_hook`` (e.g. MCL pruning) runs on each phase's product."""
    if flops_cap is None or out_capacity is None:
        fc, oc = summa3d_bounds(a, b)
        flops_cap = flops_cap or max(fc // max(phases, 1), 1024)
        out_capacity = out_capacity or max(oc // max(phases, 1), 1024)
    _, nb = b.block_shape()
    slab = -(-nb // phases)
    acc = None
    for p in range(phases):
        lo, hi = p * slab, min((p + 1) * slab, nb)
        if lo >= hi:
            break
        bp = _col_slab3d(b, lo, hi) if phases > 1 else b
        cp = summa3d_spgemm(a, bp, sr, flops_cap=flops_cap,
                            out_capacity=out_capacity)
        if phase_hook is not None:
            cp = phase_hook(cp)
        acc = cp if acc is None else _concat3d(acc, cp)
    return acc


def summa3d_bounds(a: Dist3DSpMat, b: Dist3DSpMat) -> Tuple[int, int]:
    """Host-side per-device (flops_cap, out_capacity) — max layer-local panel
    product count (conservative: computed from gathered host copies)."""
    from combblas_tpu.ops.spgemm import spgemm_flops

    al = a.to_local()
    bl = b.to_local()
    total = int(spgemm_flops(al, bl))
    # total flops is a safe upper bound for any device's layer panel
    cap = max(64, 1 << int(np.ceil(np.log2(max(total, 1)))))
    return cap, cap
