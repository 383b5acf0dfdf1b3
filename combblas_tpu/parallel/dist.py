"""DistSpMat / DistVec — 2D-grid-distributed sparse matrix and dense vector.

Counterpart of ``SpParMat`` (``SpParMat.h:67-452``: one sequential
block per MPI rank on a √p×√p grid) and ``FullyDistVec`` (``FullyDist.h:109``:
vectors spread over all p ranks with a closed-form owner function).

Design: a DistSpMat holds *block-stacked* padded-COO arrays of shape
(pr, pc, cap) sharded ``P('r', 'c', None)`` — under ``shard_map`` each device
sees exactly its (1, 1, cap) local block with block-local coordinates, i.e. the
same thing an MPI rank's ``SpDCCols`` holds in the reference.  All blocks share
one static capacity (max over blocks) so the pytree is a fixed-shape array —
the price of padding buys XLA static shapes everywhere.

Dense vectors are plain jax.Arrays of global length sharded ``P(('r','c'))``
(row-major flat over the grid) — precisely the FullyDist owner mapping, which
makes the SpMV fan-out/fan-in land on pure all_gather / reduce_scatter
(see parallel/spmv.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.parallel.grid import ProcGrid

__all__ = ["DistSpMat", "block_dims", "local_block", "dist_vec", "DistVec"]


def block_dims(gshape: Tuple[int, int], grid: ProcGrid) -> Tuple[int, int]:
    """Per-block (mb, nb): global dims padded up to grid multiples.

    The reference gives edge processors the remainder (``SpParMat.cpp``
    ``GetLocalRows``); uniform padded blocks are the XLA-native choice — the
    padding rows/cols simply never hold nonzeros.  mb is additionally rounded
    to a multiple of pc (and nb to a multiple of pr) so that the FullyDist
    vector layout tiles exactly: each device owns mb/pc of a row-block
    (nb/pr of a column-block), which is what makes the SpMV fan-out/fan-in
    collectives contiguous (see parallel/spmv.py).
    """
    m, n = gshape
    mb = -(-m // grid.pr)
    nb = -(-n // grid.pc)
    mb = -(-mb // grid.pc) * grid.pc
    nb = -(-nb // grid.pr) * grid.pr
    return mb, nb


def row_vec_len(gshape: Tuple[int, int], grid: ProcGrid) -> int:
    """Padded global length of a row-space (length-m) FullyDist vector."""
    mb, _ = block_dims(gshape, grid)
    return grid.pr * mb


def col_vec_len(gshape: Tuple[int, int], grid: ProcGrid) -> int:
    """Padded global length of a column-space (length-n) FullyDist vector."""
    _, nb = block_dims(gshape, grid)
    return grid.pc * nb


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistSpMat:
    """2D block-distributed sparse matrix.

    row/col/val: (pr, pc, cap) with block-local coordinates, sentinel-padded
    per block (row == mb, col == nb beyond each block's nnz).
    nnz: (pr, pc) int32.  gshape is the true (unpadded) global shape.
    """

    row: jax.Array
    col: jax.Array
    val: jax.Array
    nnz: jax.Array
    gshape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    grid: ProcGrid = dataclasses.field(metadata=dict(static=True))

    @property
    def capacity(self) -> int:
        return self.row.shape[-1]

    @property
    def dtype(self):
        return self.val.dtype

    def block_shape(self) -> Tuple[int, int]:
        return block_dims(self.gshape, self.grid)

    def total_nnz(self) -> jax.Array:
        return jnp.sum(self.nnz)

    def load_imbalance(self) -> jax.Array:
        """max block nnz / mean block nnz (``SpParMat::LoadImbalance``,
        ``SpParMat.cpp:762``) — 1.0 is perfectly balanced."""
        mean = jnp.maximum(jnp.mean(self.nnz.astype(jnp.float32)), 1e-9)
        return jnp.max(self.nnz).astype(jnp.float32) / mean

    # -- host constructors ------------------------------------------------
    @staticmethod
    def from_coo_arrays(
        row,
        col,
        val,
        gshape: Tuple[int, int],
        grid: ProcGrid,
        capacity: int | None = None,
        dtype=np.float32,
    ) -> "DistSpMat":
        """Host-side 2D distribution of global COO triples: bucket every entry
        to its block owner (the ``Owner()`` computation of ``SpParMat.cpp``'s
        SparseCommon shuffle, done as a host layout pass), then one sharded
        device_put.  Duplicates are summed.
        """
        row = np.asarray(row, np.int64)
        col = np.asarray(col, np.int64)
        val = np.asarray(val, dtype)
        m, n = gshape
        pr, pc = grid.pr, grid.pc
        mb, nb = block_dims(gshape, grid)
        bi, bj = row // mb, col // nb
        lr, lc = (row - bi * mb).astype(np.int32), (col - bj * nb).astype(np.int32)
        # sort by (block, local row, local col) then dedup-sum
        order = np.lexsort((lc, lr, bj, bi))
        bi, bj, lr, lc, val = bi[order], bj[order], lr[order], lc[order], val[order]
        if row.size:
            new = np.empty(row.size, bool)
            new[0] = True
            new[1:] = (
                (bi[1:] != bi[:-1])
                | (bj[1:] != bj[:-1])
                | (lr[1:] != lr[:-1])
                | (lc[1:] != lc[:-1])
            )
            seg = np.cumsum(new) - 1
            sval = np.zeros(int(seg[-1]) + 1, val.dtype)
            np.add.at(sval, seg, val)
            bi, bj, lr, lc, val = bi[new], bj[new], lr[new], lc[new], sval
        counts = np.zeros((pr, pc), np.int64)
        np.add.at(counts, (bi, bj), 1)
        cap = int(counts.max()) if capacity is None else capacity
        cap = max(8, 1 << int(np.ceil(np.log2(max(cap, 1)))))
        R = np.full((pr, pc, cap), mb, np.int32)
        C = np.full((pr, pc, cap), nb, np.int32)
        V = np.zeros((pr, pc, cap), dtype)
        # position within block = running index: entries already block-sorted
        flat_block = bi * pc + bj
        starts = np.searchsorted(flat_block, np.arange(pr * pc))
        pos = np.arange(bi.size) - starts[flat_block]
        R[bi, bj, pos] = lr
        C[bi, bj, pos] = lc
        V[bi, bj, pos] = val
        # global_put == device_put single-process; multi-process it assembles
        # the global array from every process's (identical) host copy via
        # make_array_from_callback — each device stores only its block
        from combblas_tpu.parallel.multihost import global_put

        sh = grid.block_sharding()
        return DistSpMat(
            row=global_put(R, sh),
            col=global_put(C, sh),
            val=global_put(V, sh),
            nnz=global_put(counts.astype(np.int32),
                           NamedSharding(grid.mesh, P("r", "c"))),
            gshape=(int(m), int(n)),
            grid=grid,
        )

    @staticmethod
    def from_local(a: SpCOO, grid: ProcGrid, capacity: int | None = None) -> "DistSpMat":
        """Distribute a host/single-device SpCOO onto the grid."""
        nnz = int(a.nnz)
        return DistSpMat.from_coo_arrays(
            np.asarray(a.row)[:nnz],
            np.asarray(a.col)[:nnz],
            np.asarray(a.val)[:nnz],
            a.shape,
            grid,
            capacity=capacity,
            dtype=np.asarray(a.val).dtype,
        )

    # -- conversions ------------------------------------------------------
    def to_local(self) -> SpCOO:
        """Gather to a single host SpCOO (testing / small matrices only —
        the reference's ``SaveGathered`` role)."""
        pr, pc = self.grid.pr, self.grid.pc
        mb, nb = self.block_shape()
        R = np.asarray(self.row)
        C = np.asarray(self.col)
        V = np.asarray(self.val)
        N = np.asarray(self.nnz)
        rows, cols, vals = [], [], []
        for i in range(pr):
            for j in range(pc):
                k = int(N[i, j])
                rows.append(R[i, j, :k] + i * mb)
                cols.append(C[i, j, :k] + j * nb)
                vals.append(V[i, j, :k])
        return SpCOO.from_arrays(
            np.concatenate(rows),
            np.concatenate(cols),
            np.concatenate(vals),
            self.gshape,
            sum_duplicates=False,
        )

    def to_dense(self) -> np.ndarray:
        return np.asarray(self.to_local().to_dense())


def local_block(mat: DistSpMat, row, col, val, nnz) -> SpCOO:
    """Inside shard_map: wrap this device's (1, 1, cap) slices as an SpCOO."""
    mb, nb = mat.block_shape()
    return SpCOO(
        row=row.reshape(-1),
        col=col.reshape(-1),
        val=val.reshape(-1),
        nnz=nnz.reshape(()),
        shape=(mb, nb),
    )


@dataclasses.dataclass(frozen=True)
class DistVec:
    """Thin helper describing the canonical distributed dense-vector layout.

    The data itself is a plain jax.Array of *padded* global length
    (pr*pc*chunk) with sharding P(('r','c')); this class only carries layout
    bookkeeping (true length vs padded)."""

    grid: ProcGrid
    length: int

    @property
    def padded(self) -> int:
        p = self.grid.pr * self.grid.pc
        return -(-self.length // p) * p

    def put(self, x: np.ndarray) -> jax.Array:
        from combblas_tpu.parallel.multihost import global_put

        xp = np.zeros(self.padded, x.dtype)
        xp[: self.length] = np.asarray(x)
        return global_put(xp, self.grid.vec_sharding())


def dist_vec(x, grid: ProcGrid) -> jax.Array:
    """Place a host vector in the canonical FullyDist layout (padded)."""
    x = np.asarray(x)
    return DistVec(grid, x.shape[0]).put(x)
