"""Local (single-block) semiring SpGEMM: C = A ·_sr B.

Data-parallel replacement for the reference's per-process multiply kernels
(``mtSpGEMM.h:214`` LocalHybridSpGEMM — per-column heap/hash accumulation under
OpenMP) and its symbolic estimators (``estimateFLOP`` ``mtSpGEMM.h:1058``,
``estimateNNZ_Hash`` ``:807``).  Heaps and hash tables are scalar-serial, so
the design here is the ESC scheme (expand -> sort -> compress), which is
bandwidth-bound and data-parallel in every stage:

1. *expand*: every product a_ik * b_kj becomes one slot of a flat buffer; the
   slot -> (A-nonzero, B-offset) mapping forward-fills per-run A-side fields
   with delta-scatter + int32 cumsum (exact by modular telescoping), leaving
   only the per-slot B gather, which reads a contiguous range of B per run;
   the design never uses searchsorted and never materializes multi-column
   gather outputs.
2. *sort*: one multi-key ``lax.sort`` by (i, j) — int32 keys, no packing.
3. *compress*: flag + prefix-sum + segment reduction with the semiring's add
   (see :func:`combblas_tpu.ops.coo.compress_sorted`).

Buffer capacities are static (jit) and chosen by the host-side symbolic helpers
below — the analogue of the reference's estimate-then-allocate protocol.
For large problems :func:`spgemm_rowchunked` processes disjoint row slabs of A
sequentially (``lax.map``), bounding peak memory the same way the reference's
memory-constrained path splits work (``ParFriends.h:450`` MemEfficientSpGEMM
splits B's columns; row slabs of A are the better fit here because slabs produce
disjoint output rows — no cross-slab merge is ever needed).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO, sort_compress
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = [
    "spgemm",
    "spgemm_flops",
    "spgemm_bounds",
    "spgemm_rowchunked",
    "spgemm_auto",
    "expand_products",
]


def expand_products(
    a_row: jax.Array,
    a_col: jax.Array,
    a_val: jax.Array,
    a_valid: jax.Array,
    b_col: jax.Array,
    b_val: jax.Array,
    rp_lo: jax.Array,
    rp_hi: jax.Array,
    sr: Semiring,
    flops_cap: int,
    out_sentinels: Tuple[int, int],
):
    """Expansion phase on raw arrays: materialize all products (i, j, v).

    ``rp_lo/rp_hi`` give, per inner index k, the [start, end) range of B's
    entries for row k inside the ``b_col/b_val`` buffers — for a plain SpCOO
    these are row_ptr[:-1] / row_ptr[1:], but SUMMA passes ranges into a
    *concatenated multi-block panel* (see parallel/summa.py), which is why the
    two arrays are separate.  Returns sentinel-padded (i, j, v) of length
    ``flops_cap`` plus the traced count of valid products.
    """
    m_sent, n_sent = out_sentinels
    kk = rp_lo.shape[0]
    cap_b = b_col.shape[0]
    acol = jnp.minimum(a_col, kk - 1)
    cnt = jnp.where(a_valid, rp_hi[acol] - rp_lo[acol], 0)
    offs = jnp.cumsum(cnt)  # inclusive prefix
    total = offs[-1]
    starts = offs - cnt
    t = jnp.arange(flops_cap, dtype=jnp.int32)
    # Per-slot A-side metadata without any per-slot gather: every A-side
    # field is forward-filled across its run by the delta-scatter + cumsum
    # trick: scatter (payload - previous producing payload) at each run
    # start (starts are strictly increasing over
    # producing nonzeros, so positions are unique), then an int32 cumsum
    # telescopes to the payload value everywhere in the run.  Wraparound is
    # harmless — modular telescoping is exact — so float payloads ride their
    # raw bits (bitcast), making the fill EXACT for any 32-bit field.  No
    # monotonicity of a_row is assumed (SUMMA panels concatenate blocks whose
    # row ids restart).
    has = cnt > 0
    pos = jnp.where(has, starts, flops_cap)  # dropped when out of range
    valid = t < total
    cap_a = a_row.shape[0]
    rank = jnp.cumsum(has.astype(jnp.int32)) - 1  # rank among producing nnz
    r_sc = jnp.where(has, rank, cap_a)

    def _fill(payload_int):
        compact = jnp.zeros((cap_a,), jnp.int32).at[r_sc].set(
            payload_int, mode="drop"
        )
        prev = compact[jnp.maximum(rank - 1, 0)]
        delta = jnp.where(rank > 0, payload_int - prev, payload_int)
        seeded = jnp.zeros((flops_cap,), jnp.int32).at[pos].set(
            delta, mode="drop"
        )
        return jnp.cumsum(seeded)

    # b_idx = b_start + (t - run_start) = t + shift; bias keeps shift >= 0.
    shift = rp_lo[acol] - starts + flops_cap
    i = _fill(a_row)
    shift_f = _fill(shift)
    a_val_f = jax.lax.bitcast_convert_type(
        _fill(jax.lax.bitcast_convert_type(a_val.astype(jnp.float32),
                                           jnp.int32)),
        jnp.float32,
    ).astype(a_val.dtype) if jnp.issubdtype(a_val.dtype, jnp.floating) else \
        _fill(a_val.astype(jnp.int32)).astype(a_val.dtype)
    b_idx = jnp.minimum(t + shift_f - flops_cap, cap_b - 1)
    b_idx = jnp.maximum(b_idx, 0)
    # The one unavoidable random access (B's column id and value per
    # product) as two 1-wide gathers over contiguous B row ranges.
    j = jnp.where(valid, b_col[b_idx], n_sent)
    bv = b_val[b_idx]
    i = jnp.where(valid, i, m_sent)
    v = jnp.where(valid, sr.mul(a_val_f, bv), 0)
    return i, j, v, total




def _expand(a: SpCOO, b: SpCOO, b_rp: jax.Array, sr: Semiring, flops_cap: int):
    """Expansion for whole local operands (see :func:`expand_products`)."""
    m, k = a.shape
    k2, n = b.shape
    assert k == k2, (a.shape, b.shape)
    return expand_products(
        a.row,
        a.col,
        a.val,
        a.mask(),
        b.col,
        b.val,
        b_rp[:-1],
        b_rp[1:],
        sr,
        flops_cap,
        (m, n),
    )


@functools.partial(jax.jit, static_argnames=("sr", "flops_cap", "out_capacity"))
def spgemm(
    a: SpCOO,
    b: SpCOO,
    sr: Semiring = PLUS_TIMES,
    *,
    flops_cap: int,
    out_capacity: int,
) -> SpCOO:
    """Single-pass ESC SpGEMM.  ``flops_cap`` must bound the true product count
    (see :func:`spgemm_bounds`); producing more than ``flops_cap`` products is
    silently truncated, so callers use the host-side bound helpers.
    """
    check_sort_limit(flops_cap, "ESC expansion sort")
    b_rp = b.row_ptr()
    i, j, v, total = _expand(a, b, b_rp, sr, flops_cap)
    return sort_compress(
        i, j, v, total, (a.shape[0], b.shape[1]), sr=sr, out_capacity=out_capacity
    )


@jax.jit
def _flops_partials(a: SpCOO, b: SpCOO):
    """Per-group (lo, hi) limb partial sums of the per-nonzero product counts.

    int32 alone wraps once total flops pass 2^31 (true from R-MAT scale ~18
    up), and the library runs without 64-bit mode — so counts are split into
    16-bit limbs, summed per 2^14-element group (each partial provably < 2^31), and
    the handful of partials are combined exactly on the host in int64."""
    k = a.shape[1]
    b_rp = b.row_ptr()
    acol = jnp.minimum(a.col, k)
    cnt = jnp.where(a.mask(), b_rp[acol + 1] - b_rp[acol], 0)
    g = 1 << 14
    pad = (-cnt.shape[0]) % g
    cnt = jnp.concatenate([cnt, jnp.zeros((pad,), cnt.dtype)]).reshape(-1, g)
    lo = jnp.sum(cnt & 0xFFFF, axis=1)  # <= 2^14 * 2^16 = 2^30
    hi = jnp.sum(cnt >> 16, axis=1)     # <= 2^14 * 2^15 = 2^29
    return lo, hi


def spgemm_flops(a: SpCOO, b: SpCOO) -> int:
    """Exact number of semiring multiplications for A·B (the reference's
    ``EstimateFLOP``, ``ParFriends.h:356`` / ``mtSpGEMM.h:1058``).  Host-side
    exact int (immune to int32 wraparound at scale >= 18)."""
    lo, hi = _flops_partials(a, b)
    return int(
        np.asarray(lo).astype(np.int64).sum()
        + (np.asarray(hi).astype(np.int64).sum() << 16)
    )


def round_capacity_frac(n: int, frac: int = 8) -> int:
    """Round up to the next 1/frac-of-a-power-of-two step: keeps compile-cache
    reuse high while wasting at most ~1/frac of buffer work (plain pow2
    rounding wastes up to 2x, which is pure streamed overhead in ESC)."""
    n = max(n, 8)
    step = max((1 << int(np.floor(np.log2(n)))) // frac, 8)
    return -(-n // step) * step


def spgemm_bounds(a: SpCOO, b: SpCOO) -> Tuple[int, int]:
    """Host-side (flops_cap, out_capacity) for :func:`spgemm`.

    Pulls the exact FLOP count to host once (cheap scalar transfer); buffers
    round to 1/8-pow2 steps (see :func:`round_capacity_frac`).
    out_capacity <= flops since compression only shrinks.
    """
    flops = int(spgemm_flops(a, b))
    cap = round_capacity_frac(flops)
    return cap, cap


def _slab_bounds_host(a: SpCOO, b: SpCOO, num_slabs: int) -> Tuple[int, int]:
    """Max per-slab flops over row slabs of A (host side)."""
    m = a.shape[0]
    slab_rows = -(-m // num_slabs)
    a_rp = np.asarray(a.row_ptr())
    b_rp = np.asarray(b.row_ptr())
    acol = np.minimum(np.asarray(a.col), a.shape[1] - 1)
    cnt = np.where(
        np.asarray(a.mask()), b_rp[acol + 1] - b_rp[acol], 0
    ).astype(np.int64)
    coffs = np.concatenate([[0], np.cumsum(cnt)])
    worst = 0
    for s in range(num_slabs):
        lo = a_rp[min(s * slab_rows, m)]
        hi = a_rp[min((s + 1) * slab_rows, m)]
        worst = max(worst, int(coffs[hi] - coffs[lo]))
    cap = max(8, 1 << int(np.ceil(np.log2(max(worst, 1)))))
    return cap, slab_rows


@functools.partial(
    jax.jit,
    static_argnames=("sr", "num_slabs", "slab_rows", "flops_cap", "out_capacity"),
)
def spgemm_rowchunked(
    a: SpCOO,
    b: SpCOO,
    sr: Semiring = PLUS_TIMES,
    *,
    num_slabs: int,
    slab_rows: int,
    flops_cap: int,
    out_capacity: int,
) -> SpCOO:
    """Memory-bounded ESC SpGEMM over disjoint row slabs of A.

    Each slab s multiplies A[s*slab_rows:(s+1)*slab_rows, :] by B with a
    per-slab expansion buffer of ``flops_cap`` slots.  Because slabs own
    disjoint output rows and run in increasing row order, the concatenated
    slab outputs are already globally (row, col)-sorted except for interleaved
    padding — the final compaction is a single sentinel-dropping scatter, not a
    sort.  Peak memory ~ flops_cap instead of total FLOPs.
    """
    m, k = a.shape
    n = b.shape[1]
    b_rp = b.row_ptr()
    a_rp = a.row_ptr()
    # per-slab nnz <= per-slab products <= flops_cap, so slab compression can
    # never truncate; only the global buffer can (detected by the caller)
    slab_out_cap = flops_cap

    def do_slab(s):
        lo = a_rp[jnp.minimum(s * slab_rows, m)]
        hi = a_rp[jnp.minimum((s + 1) * slab_rows, m)]
        # Gather A's nnz range [lo, hi) to the front of a cap-sized window.
        t = jnp.arange(a.capacity, dtype=jnp.int32)
        src = jnp.minimum(lo + t, a.capacity - 1)
        sub = SpCOO(
            row=a.row[src],
            col=a.col[src],
            val=a.val[src],
            nnz=(hi - lo).astype(jnp.int32),
            shape=a.shape,
        )
        i, j, v, total = _expand(sub, b, b_rp, sr, flops_cap)
        c = sort_compress(i, j, v, total, (m, n), sr=sr, out_capacity=slab_out_cap)
        return c.row, c.col, c.val, c.nnz

    rows, cols, vals, nnzs = jax.lax.map(
        do_slab, jnp.arange(num_slabs, dtype=jnp.int32)
    )
    # Compact: slab s's entries go to positions [prefix[s], prefix[s] + nnz[s]).
    prefix = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(nnzs).astype(jnp.int32)]
    )
    total_nnz = jnp.minimum(prefix[-1], out_capacity)  # clamp: see spgemm_auto
    pos_in = jnp.broadcast_to(
        jnp.arange(slab_out_cap, dtype=jnp.int32)[None, :], (num_slabs, slab_out_cap)
    )
    dest = prefix[:-1][:, None] + pos_in
    valid = pos_in < nnzs[:, None]
    dest = jnp.where(valid, dest, out_capacity)  # dropped by scatter mode
    out_row = jnp.full((out_capacity,), m, jnp.int32).at[dest.ravel()].set(
        rows.ravel(), mode="drop"
    )
    out_col = jnp.full((out_capacity,), n, jnp.int32).at[dest.ravel()].set(
        cols.ravel(), mode="drop"
    )
    out_val = jnp.zeros((out_capacity,), vals.dtype).at[dest.ravel()].set(
        vals.ravel(), mode="drop"
    )
    return SpCOO(
        row=out_row,
        col=out_col,
        val=out_val,
        nnz=total_nnz.astype(jnp.int32),
        shape=(m, n),
    )


def stream_capacity(flops: int) -> int:
    """Expansion stream capacity for ``flops`` products, rounded up to a
    multiple of 32768 so slabs of similar weight share a compiled shape."""
    return max(-(-flops // 32768) * 32768, 32768)


def _slab_extract(a: SpCOO, k: int, bounds, s, *, span_cap: int,
                  slab_nnz_cap: int):
    """A's nnz window for rows [bounds[s], bounds[s+1]), rows rebased
    slab-local.  Returns (sub SpCOO with shape (span_cap, k), row_lo)."""
    row_lo = bounds[s]
    row_hi = bounds[s + 1]
    # two scalar binary searches, not the full m+1 row_ptr map (a per-slab
    # O(m log nnz) pass); pads carry row == m >= row_hi, so the sorted
    # invariant covers them
    lohi = jnp.minimum(
        jnp.searchsorted(a.row, jnp.stack([row_lo, row_hi])).astype(
            jnp.int32),
        a.nnz)
    lo = lohi[0]
    hi = lohi[1]
    t = jnp.arange(slab_nnz_cap, dtype=jnp.int32)
    src = jnp.minimum(lo + t, a.capacity - 1)
    sel = t < (hi - lo)
    sub = SpCOO(
        row=jnp.where(sel, jnp.minimum(a.row[src] - row_lo, span_cap),
                      span_cap),
        col=jnp.where(sel, a.col[src], k),
        val=jnp.where(sel, a.val[src], 0),
        nnz=(hi - lo).astype(jnp.int32),
        shape=(span_cap, k),
    )
    return sub, row_lo


# XLA's stable sort cannot exceed 2^31-1 elements; every ESC pipeline here
# sorts a stream bounded by its flops/stream cap, so caps must stay below
# this (library-enforced, so an oversized plan fails with a named error and
# not inside XLA).  2^30 leaves headroom for capacity rounding.
SORT_ELEM_LIMIT = 1 << 30


class SpGEMMSortLimitError(ValueError):
    """A single sort stage would exceed XLA's 2^31-element stable-sort
    limit.  Use spgemm_auto (auto-slabs), spgemm_streamed_seg2, or a
    smaller flops_cap."""


def check_sort_limit(n_elems: int, what: str = "sort stream") -> None:
    if n_elems > SORT_ELEM_LIMIT:
        raise SpGEMMSortLimitError(
            f"{what} of {n_elems} elements exceeds the XLA stable-sort "
            f"limit ({SORT_ELEM_LIMIT}); use spgemm_auto / seg2 slabbing "
            "or lower flops_cap")


def spgemm_auto(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                max_flops_cap: int = 1 << 24, out_capacity: int | None = None,
                nnz_estimate: int | None = None,
                plan: dict | None = None) -> SpCOO:
    """Host-driven dispatcher: single-pass when the expansion fits, row-chunked
    otherwise, with estimate-and-retry output sizing.

    Oversized output buffers multiply streamed traffic (every compress pass
    touches out_capacity-sized arrays), so, like the reference's symbolic
    estimate-then-allocate protocol (``estimateNNZ_Hash``, ``mtSpGEMM.h:807``),
    the output is sized from an estimate (``nnz_estimate``, e.g. last
    iteration's nnz in MCL; default flops/2 bounded by the dense cell count)
    and the multiply retried with a doubled buffer when compression reports
    truncation (nnz == capacity) — rare, and each retry is cheap relative to
    a always-worst-case buffer.

    ``plan``: a caller-held mutable dict freezing every static shape
    (pipeline choice + capacities, sized with headroom).  Iterated callers
    (the MCL expansion loop) pass the same dict each call: while the
    operands' capacities match and the product's flops fit the frozen
    stream, the exact compiled executable is reused — no replanning, no
    recompiles."""
    # library-enforced sort bound: a single slab never sorts > 2^31 elems
    max_flops_cap = min(max_flops_cap, SORT_ELEM_LIMIT)
    dense_cells = a.shape[0] * b.shape[1]
    key = (int(a.capacity), int(b.capacity), a.shape, b.shape,
           out_capacity, id(sr))
    flops_exact = int(spgemm_flops(a, b))
    if plan is not None and plan.get("key") == key and \
            flops_exact <= plan["flops_ok"] and \
            flops_exact * 64 >= plan["flops_ok"]:
        # reuse frozen statics below; the lower bound forces a replan
        # (and shrink) only on a 64x collapse: oversized buffers cost
        # streamed compress traffic, but less than a fresh compile, so
        # MCL's fast early decay must not replan every iteration
        pass
    else:
        # freeze above current flops: every steady-state pass sorts the
        # frozen stream, so headroom is paid every iteration — 1.5x is
        # enough band for MCL's post-peak growth without replans
        froz_fl = round_capacity_frac(
            max(flops_exact, 8) * 3 // 2 if plan is not None
            else max(flops_exact, 8))
        flops_cap = round_capacity_frac(max(flops_exact, 8))
        oc = flops_cap
        if out_capacity is not None:
            out_cap = out_capacity
        else:
            est = nnz_estimate if nnz_estimate is not None else max(
                flops_cap // 2, 8
            )
            out_cap = round_capacity_frac(
                int(min(est, oc, max(dense_cells, 8))))
        fresh = dict(key=key, flops_ok=froz_fl, out_cap=out_cap, oc=oc,
                     kind="sort", flops_cap=round_capacity_frac(froz_fl))
        if flops_cap > max_flops_cap:
            fresh.update(kind="rowchunked",
                         num_slabs=-(-flops_cap // max_flops_cap) * 2)
        if plan is None:
            plan = fresh
        else:
            plan.clear()
            plan.update(fresh)
    out_cap = plan["out_cap"]
    while True:
        if plan["kind"] == "sort":
            check_sort_limit(plan["flops_cap"], "ESC expansion")
            c = spgemm(a, b, sr, flops_cap=plan["flops_cap"],
                       out_capacity=out_cap)
        else:
            slab_cap, slab_rows = _slab_bounds_host(a, b, plan["num_slabs"])
            c = spgemm_rowchunked(
                a, b, sr,
                num_slabs=plan["num_slabs"], slab_rows=slab_rows,
                flops_cap=slab_cap, out_capacity=out_cap,
            )
        full = int(c.nnz) >= out_cap
        if not full or out_cap >= min(plan["oc"], max(dense_cells, 8)):
            return c
        out_cap = round_capacity_frac(out_cap * 2)
        plan["out_cap"] = out_cap
