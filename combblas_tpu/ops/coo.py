"""SpCOO — the core local sparse-matrix format: capacity-padded coordinate triples.

Replacement for the reference's sequential formats
(``SpTuples.h:65-429`` COO, ``dcsc.h:46-135`` DCSC, ``csc.h:43`` CSC).  XLA
requires static shapes, so instead of exactly-sized triple lists we keep a
*capacity*-sized buffer with a traced ``nnz`` scalar; entries at index >= nnz
are padding with ``row == m`` / ``col == n`` sentinels so they sort past every
real entry.  The canonical invariant is **row-major (row, col) sorted and
deduplicated** — the role DCSC's ``cp/jc/ir`` arrays play in the reference is
played here by ``row_ptr()`` (a searchsorted over the sorted row ids), which
works equally well for hypersparse blocks because the buffer is nnz-sized, not
n-sized (same motivation as DCSC, reference ``README.md:131-137``).

All operations are pure functions over this pytree, so the same code paths run
under ``jit``, ``vmap``, and ``shard_map`` on device blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = ["SpCOO", "sort_coo", "compress_sorted", "compress_sorted_masked",
           "sort_compress_packed",
           "merge", "row_split", "row_concat", "find"]


def find(a: "SpCOO"):
    """Matlab-style ``[i, j, v] = find(A)`` (``SpParMat::Find``,
    ``SpParMat.cpp:4760``): host triple extraction; round-trips through
    ``SpCOO.from_arrays`` (the FindSparse test pattern)."""
    import numpy as _np

    nnz = int(a.nnz)
    return (
        _np.asarray(a.row)[:nnz],
        _np.asarray(a.col)[:nnz],
        _np.asarray(a.val)[:nnz],
    )


def _round_capacity(n: int) -> int:
    """Round a capacity up to a coarse bucket so recompiles are rare."""
    if n <= 8:
        return 8
    return 1 << int(np.ceil(np.log2(n)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpCOO:
    """Padded COO sparse matrix with static capacity and traced nnz.

    Fields ``row``/``col``/``val`` have static length ``capacity``; the first
    ``nnz`` entries are real, the rest are (m, n, 0) sentinels.  ``shape`` is
    static metadata.
    """

    row: jax.Array  # int32[capacity]
    col: jax.Array  # int32[capacity]
    val: jax.Array  # dtype[capacity]
    nnz: jax.Array  # int32 scalar (traced)
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    # -- static helpers ---------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def mask(self) -> jax.Array:
        """Boolean mask of valid entries."""
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.nnz

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_arrays(
        row,
        col,
        val,
        shape: Tuple[int, int],
        capacity: int | None = None,
        sum_duplicates: bool = True,
        dtype=None,
    ) -> "SpCOO":
        """Host-side constructor: sorts, optionally sums duplicates, pads.

        Plays the role of the ``SpTuples`` -> ``SpDCCols`` conversion
        (``SpDCCols.h:60``).  Not jittable; use on numpy inputs.
        """
        row = np.asarray(row, np.int32)
        col = np.asarray(col, np.int32)
        val = np.asarray(val, dtype if dtype is not None else None)
        if dtype is None and val.dtype == np.float64:
            val = val.astype(np.float32)
        m, n = shape
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
        if sum_duplicates and row.size:
            key_new = np.empty(row.size, bool)
            key_new[0] = True
            key_new[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
            seg = np.cumsum(key_new) - 1
            nout = int(seg[-1]) + 1
            out_val = np.zeros(nout, val.dtype)
            np.add.at(out_val, seg, val)
            row, col, val = row[key_new], col[key_new], out_val
        nnz = row.size
        cap = _round_capacity(nnz) if capacity is None else capacity
        assert cap >= nnz, (cap, nnz)
        prow = np.full(cap, m, np.int32)
        pcol = np.full(cap, n, np.int32)
        pval = np.zeros(cap, val.dtype)
        prow[:nnz], pcol[:nnz], pval[:nnz] = row, col, val
        return SpCOO(
            row=jnp.asarray(prow),
            col=jnp.asarray(pcol),
            val=jnp.asarray(pval),
            nnz=jnp.asarray(nnz, jnp.int32),
            shape=(int(m), int(n)),
        )

    @staticmethod
    def from_dense(dense, capacity: int | None = None) -> "SpCOO":
        dense = np.asarray(dense)
        row, col = np.nonzero(dense)
        return SpCOO.from_arrays(
            row, col, dense[row, col], dense.shape, capacity=capacity
        )

    @staticmethod
    def eye(n: int, value=1.0, dtype=jnp.float32,
            capacity: int | None = None) -> "SpCOO":
        """Sparse identity (scaled by ``value``) without materializing a
        dense (n, n) array — the self-loop matrix of ``AddLoops``
        (``SpParMat.cpp:3294``) costs O(n), not O(n^2)."""
        idx = np.arange(n, dtype=np.int32)
        return SpCOO.from_arrays(
            idx, idx, np.full((n,), value, np.float32), (n, n),
            capacity=capacity, sum_duplicates=False, dtype=dtype,
        )

    @staticmethod
    def empty(shape: Tuple[int, int], capacity: int = 8, dtype=jnp.float32) -> "SpCOO":
        m, n = shape
        return SpCOO(
            row=jnp.full((capacity,), m, jnp.int32),
            col=jnp.full((capacity,), n, jnp.int32),
            val=jnp.zeros((capacity,), dtype),
            nnz=jnp.asarray(0, jnp.int32),
            shape=(int(m), int(n)),
        )

    # -- conversions ------------------------------------------------------
    def to_dense(self) -> jax.Array:
        """Dense (m, n) array; padding contributes nothing.  Jittable."""
        m, n = self.shape
        valid = self.mask()
        r = jnp.where(valid, self.row, m)
        c = jnp.where(valid, self.col, 0)
        v = jnp.where(valid, self.val, 0)
        out = jnp.zeros((m + 1, n), self.val.dtype)
        out = out.at[r, c].add(v)
        return out[:m]

    def row_ptr(self) -> jax.Array:
        """CSR-style row pointer array int32[m+1] via searchsorted.

        Replaces DCSC's ``cp/jc`` column map (``dcsc.h:109`` ConstructAux);
        O(m log cap) but fully vectorized.  Requires row-sorted invariant.
        """
        m = self.shape[0]
        bounds = jnp.arange(m + 1, dtype=jnp.int32)
        ptr = jnp.searchsorted(self.row, bounds, side="left").astype(jnp.int32)
        return jnp.minimum(ptr, self.nnz)

    def transpose(self) -> "SpCOO":
        """(n, m) transpose: swap coords and re-sort (``SpDCCols`` Transpose)."""
        m, n = self.shape
        valid = self.mask()
        t = SpCOO(
            row=jnp.where(valid, self.col, n),
            col=jnp.where(valid, self.row, m),
            val=self.val,
            nnz=self.nnz,
            shape=(n, m),
        )
        return sort_coo(t)

    def astype(self, dtype) -> "SpCOO":
        return dataclasses.replace(self, val=self.val.astype(dtype))

    def with_capacity(self, capacity: int) -> "SpCOO":
        """Grow/shrink the padding buffer (host-side decision, jittable body)."""
        m, n = self.shape
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity > cap:
            pad = capacity - cap
            return SpCOO(
                row=jnp.concatenate([self.row, jnp.full((pad,), m, jnp.int32)]),
                col=jnp.concatenate([self.col, jnp.full((pad,), n, jnp.int32)]),
                val=jnp.concatenate([self.val, jnp.zeros((pad,), self.val.dtype)]),
                nnz=self.nnz,
                shape=self.shape,
            )
        return SpCOO(
            row=self.row[:capacity],
            col=self.col[:capacity],
            val=self.val[:capacity],
            nnz=jnp.minimum(self.nnz, capacity),
            shape=self.shape,
        )


def sort_coo(a: SpCOO) -> SpCOO:
    """Restore the (row, col) sorted invariant.

    Multi-operand lexicographic ``lax.sort`` — no 64-bit key packing needed, so
    indices stay int32 (the library runs without 64-bit mode).
    """
    row, col, val = jax.lax.sort((a.row, a.col, a.val), num_keys=2)
    return dataclasses.replace(a, row=row, col=col, val=val)


def compress_sorted(
    row: jax.Array,
    col: jax.Array,
    val: jax.Array,
    nvalid: jax.Array,
    shape: Tuple[int, int],
    sr: Semiring = PLUS_TIMES,
    out_capacity: int | None = None,
) -> SpCOO:
    """Deduplicate a (row, col)-sorted triple stream with semiring addition.

    The data-parallel equivalent of the reference's k-way merges
    (``MultiwayMerge.h:412/537``) and of ``SpTuples`` duplicate folding: equal
    keys are adjacent after sorting, so duplicate folding is a flag + prefix-sum
    + segment reduction.  ``nvalid`` is the traced count of
    real entries (the first ``nvalid`` positions; the rest must hold sentinels
    that sort last).  Output is a canonical :class:`SpCOO`.
    """
    valid = jnp.arange(row.shape[0], dtype=jnp.int32) < nvalid
    return compress_sorted_masked(row, col, val, valid, shape, sr=sr,
                                  out_capacity=out_capacity)


def compress_sorted_masked(
    row: jax.Array,
    col: jax.Array,
    val: jax.Array,
    valid: jax.Array,
    shape: Tuple[int, int],
    sr: Semiring = PLUS_TIMES,
    out_capacity: int | None = None,
) -> SpCOO:
    """:func:`compress_sorted` for a stream whose real entries are marked by
    the boolean ``valid`` instead of forming a prefix: the real entries,
    read in order, must be (row, col)-sorted, and invalid entries may sit
    anywhere between them (the padded row windows of the streamed SpGEMM)."""
    m, n = shape
    out_cap = row.shape[0] if out_capacity is None else out_capacity
    # Segment starts: first valid entry, or key change.
    prev_row = jnp.concatenate([jnp.full((1,), -1, jnp.int32), row[:-1]])
    prev_col = jnp.concatenate([jnp.full((1,), -1, jnp.int32), col[:-1]])
    is_new = ((row != prev_row) | (col != prev_col)) & valid
    seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1  # segment id per entry
    # clamp on overflow: callers detect truncation via nnz == out_capacity
    # and retry with a bigger buffer (spgemm_auto's estimate-and-retry)
    nnz_out = jnp.minimum(jnp.maximum(seg[-1] + 1, 0), out_cap)
    seg_sc = jnp.where(valid, seg, out_cap)  # padding scatters out of range
    if sr.add_kind == "sum":
        out_val = jax.ops.segment_sum(
            jnp.where(valid, val, 0), seg_sc, num_segments=out_cap
        )
    elif sr.add_kind == "min":
        out_val = jax.ops.segment_min(
            jnp.where(valid, val, sr.zero(val.dtype)), seg_sc, num_segments=out_cap
        )
        out_val = jnp.where(
            jnp.arange(out_cap, dtype=jnp.int32) < nnz_out, out_val, 0
        )
    else:
        out_val = jax.ops.segment_max(
            jnp.where(valid, val, sr.zero(val.dtype)), seg_sc, num_segments=out_cap
        )
        out_val = jnp.where(
            jnp.arange(out_cap, dtype=jnp.int32) < nnz_out, out_val, 0
        )
    out_row = jnp.full((out_cap,), m, jnp.int32).at[seg_sc].set(
        jnp.where(valid, row, m), mode="drop"
    )
    out_col = jnp.full((out_cap,), n, jnp.int32).at[seg_sc].set(
        jnp.where(valid, col, n), mode="drop"
    )
    # Scatter above writes every entry of a segment; sorted order makes all
    # writes within a segment identical, so the result is deterministic.
    return SpCOO(
        row=out_row,
        col=out_col,
        val=out_val.astype(val.dtype),
        nnz=nnz_out.astype(jnp.int32),
        shape=(int(m), int(n)),
    )


def row_split(a: SpCOO, nsplits: int) -> list:
    """Split into ``nsplits`` row bands (``SpDCCols::RowSplit`` /
    ``Split``, ``SpDCCols.h:281-294`` — the reference uses this for
    per-thread work division; here it serves phase/block iteration)."""
    m, n = a.shape
    band = -(-m // nsplits)
    rp = a.row_ptr()
    out = []
    idx = jnp.arange(a.capacity, dtype=jnp.int32)
    for s in range(nsplits):
        lo, hi = rp[min(s * band, m)], rp[min((s + 1) * band, m)]
        src = jnp.minimum(lo + idx, a.capacity - 1)
        rows_here = min(band, m - s * band) if s * band < m else 0
        sel = idx < (hi - lo)
        out.append(
            SpCOO(
                row=jnp.where(sel, a.row[src] - s * band, rows_here),
                col=jnp.where(sel, a.col[src], n),
                val=jnp.where(sel, a.val[src], 0),
                nnz=(hi - lo).astype(jnp.int32),
                shape=(max(rows_here, 1), n),
            )
        )
    return out


def row_concat(parts: list) -> SpCOO:
    """Inverse of :func:`row_split` (``SpDCCols::Merge``)."""
    n = parts[0].shape[1]
    rows, cols, vals = [], [], []
    off = 0
    total_m = sum(p.shape[0] for p in parts)
    for p in parts:
        valid = p.mask()
        rows.append(jnp.where(valid, p.row + off, total_m))
        cols.append(jnp.where(valid, p.col, n))
        vals.append(jnp.where(valid, p.val, 0))
        off += p.shape[0]
    row = jnp.concatenate(rows)
    col = jnp.concatenate(cols)
    val = jnp.concatenate(vals)
    row, col, val = jax.lax.sort((row, col, val), num_keys=2)
    nnz = sum(p.nnz for p in parts)
    return SpCOO(row=row, col=col, val=val, nnz=nnz.astype(jnp.int32),
                 shape=(total_m, n))


def sort_compress_packed(
    key: jax.Array,
    v: jax.Array,
    nvalid: jax.Array,
    shape: Tuple[int, int],
    sr: Semiring = PLUS_TIMES,
    out_capacity: int | None = None,
) -> SpCOO:
    """Sort a packed-key stream (key = i*(n+1) + j; padding keys must sort
    after every real key) and fold duplicates.  The packed back-end of
    :func:`sort_compress`.  All compression scatters carry
    ``indices_are_sorted`` (segment ids are sorted by construction)."""
    m, n = shape
    stride = n + 1
    cap = key.shape[0]
    out_cap = cap if out_capacity is None else out_capacity
    key, v = jax.lax.sort((key, v), num_keys=1)
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < nvalid
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), key[:-1]])
    is_new = (key != prev) & valid
    seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    nnz_out = jnp.minimum(
        jnp.maximum(seg[-1] + 1, 0) * (nvalid > 0), out_cap
    )
    seg_sc = jnp.where(valid, seg, out_cap)
    if sr.add_kind == "sum":
        out_val = jax.ops.segment_sum(
            jnp.where(valid, v, 0), seg_sc, num_segments=out_cap,
            indices_are_sorted=True,
        )
    elif sr.add_kind == "min":
        out_val = jax.ops.segment_min(
            jnp.where(valid, v, sr.zero(v.dtype)), seg_sc,
            num_segments=out_cap, indices_are_sorted=True,
        )
        out_val = jnp.where(
            jnp.arange(out_cap, dtype=jnp.int32) < nnz_out, out_val, 0
        )
    else:
        out_val = jax.ops.segment_max(
            jnp.where(valid, v, sr.zero(v.dtype)), seg_sc,
            num_segments=out_cap, indices_are_sorted=True,
        )
        out_val = jnp.where(
            jnp.arange(out_cap, dtype=jnp.int32) < nnz_out, out_val, 0
        )
    sent = (m + 1) * stride - 1
    out_key = jnp.full((out_cap,), sent, jnp.int32).at[seg_sc].set(
        jnp.where(valid, key, sent), mode="drop", indices_are_sorted=True
    )
    return SpCOO(
        row=jnp.minimum(out_key // stride, m),
        col=jnp.minimum(out_key % stride, n),
        val=out_val.astype(v.dtype),
        nnz=nnz_out.astype(jnp.int32),
        shape=(int(m), int(n)),
    )


def sort_compress(
    i: jax.Array,
    j: jax.Array,
    v: jax.Array,
    nvalid: jax.Array,
    shape: Tuple[int, int],
    sr: Semiring = PLUS_TIMES,
    out_capacity: int | None = None,
) -> SpCOO:
    """Sort a sentinel-padded triple stream and fold duplicates — the ESC
    back-end.  When the coordinate space packs into int31 (mb*(nb+1) < 2^31 —
    true for every distributed block and single-chip graphs to scale ~15 per
    dim pair), a single packed key replaces the two-key sort and the row/col
    scatters in compression collapse into one, cutting two full passes over
    the stream."""
    m, n = shape
    cap = i.shape[0]
    out_cap = cap if out_capacity is None else out_capacity
    stride = n + 1  # sentinel col == n must pack without collision
    if (m + 1) * stride < (1 << 31):
        key = i * stride + j
        return sort_compress_packed(
            key, v, nvalid, shape, sr=sr, out_capacity=out_cap
        )
    i, j, v = jax.lax.sort((i, j, v), num_keys=2)
    return compress_sorted(i, j, v, nvalid, shape, sr=sr, out_capacity=out_cap)


def merge(
    a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, out_capacity: int | None = None
) -> SpCOO:
    """Merge two matrices of the same shape, combining duplicates with sr.add.

    Concat + sort + compress — the two-way case of the reference's
    ``MultiwayMerge`` (``MultiwayMerge.h:184``).
    """
    assert a.shape == b.shape, (a.shape, b.shape)
    row = jnp.concatenate([a.row, b.row])
    col = jnp.concatenate([a.col, b.col])
    val = jnp.concatenate([a.val, b.val])
    row, col, val = jax.lax.sort((row, col, val), num_keys=2)
    out_cap = out_capacity if out_capacity is not None else a.capacity + b.capacity
    return compress_sorted(
        row, col, val, a.nnz + b.nnz, a.shape, sr=sr, out_capacity=out_cap
    )
