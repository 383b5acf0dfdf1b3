"""Slab-streamed ESC SpGEMM over sorted rows (seg2): the headline pipeline.

For products whose output does not fit on the device, every row slab's C
block is formed, merged and compacted on device, folded into a digest
(nnz, checksum) and released — the terminal form of the reference's
memory-bounded phasing (``MemEfficientSpGEMM``, ``ParFriends.h:450``).

The plan permutes A's rows by descending product count (a row permutation
of A permutes C's rows but changes neither nnz nor the value multiset, so
the digest is unchanged) and cuts the sorted order into contiguous slabs.
Each slab gets ONE window width ``w`` from a small matrix-adaptive ladder:

  - the slab's products are expanded with :func:`ops.spgemm.expand_products`
    in A-entry order, so each output row's products form one contiguous run;
  - each row's run becomes one ``w``-wide window (``w`` strictly greater
    than the row's product count, so every window ends with >= 1 sentinel);
  - the (s_pad, w) batch is sorted along dim 1 by column id only — the
    row order is already known, so no slab-wide two-key sort is needed;
  - duplicates are folded by :func:`ops.coo.compress_sorted_masked` and the
    result is digested.

Rows with fewer than ``flat_max_fl`` products skip the windows: their
slab's stream is sorted flat by (row, col) with two int32 keys (no packed
key, so no int32 range limit) and compressed the same way.

Reference counterpart: the hash-SpGEMM of ``mtSpGEMM.h:362-440`` is
insensitive to row order; the row sort buys the sort formulation the same
insensitivity, while keeping the all-duplicates-merged semantics
(``MultiwayMerge.h:537``)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from combblas_tpu.ops.coo import SpCOO, compress_sorted, compress_sorted_masked
from combblas_tpu.ops.spgemm import (
    _slab_extract,
    check_sort_limit,
    expand_products,
    round_capacity_frac,
    stream_capacity,
)
from combblas_tpu.semiring import PLUS_TIMES, Semiring

__all__ = ["seg2_plan", "seg2_prepare", "seg2_step", "seg_zero_state",
           "spgemm_streamed_seg2"]

_SENT = jnp.iinfo(jnp.int32).max
_MIN_CLS = 7  # smallest window = 2^7 = 128


def _width_gran(L: int) -> int:
    """Window count granularity so a window buffer S*L is a whole number of
    32768-element blocks."""
    import math

    return max(32768 // math.gcd(L, 32768), 1)


def _row_flops_exact(a: SpCOO, b_rp: jax.Array, span_cap: int):
    """Exact int32 per-slab-local-row product counts (span_cap+1,) and the
    exclusive cumsum of stream start offsets.  Rows are slab-local (pads
    land on span_cap).  Exactness matters: a row's window width bounds its
    products, and an undercounted row would silently truncate them."""
    kk = b_rp.shape[0] - 1
    acol = jnp.minimum(a.col, kk - 1)
    cnt = jnp.where(a.mask(), b_rp[acol + 1] - b_rp[acol], 0)
    rowfl = jax.ops.segment_sum(
        cnt, jnp.minimum(a.row, span_cap), num_segments=span_cap + 1
    )
    row_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(rowfl)[:-1]]
    )
    return rowfl, row_start


def seg_zero_state():
    """Initial digest state: (nnz low limb, nnz high limb, checksum,
    truncated)."""
    return (
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0.0, jnp.float32),
        jnp.asarray(False),
    )


def _fold_digest(c: SpCOO, total_lo, total_hi, checksum, truncated,
                 slab_out_cap: int):
    """Fold one slab's compressed block into the digest.  The nnz total
    accumulates as 16-bit-split int32 partials (scale-22 totals exceed
    int32), so no per-slab host sync is needed and the host combines
    exactly."""
    live = jnp.arange(c.capacity, dtype=jnp.int32) < c.nnz
    cs = jnp.sum(jnp.where(live, c.val.astype(jnp.float32), 0.0))
    return (total_lo + (c.nnz & 0xFFFF), total_hi + (c.nnz >> 16),
            checksum + cs, truncated | (c.nnz >= slab_out_cap))


def _pow4_cap(n: int) -> int:
    """Round up to the next power of 4 (coarse cap for cheap dimensions)."""
    n = max(n, 256)
    p = 1
    while p < n:
        p <<= 2
    return p


def _spad_for(w: int, n_class: int, flops_cap: int, pad_cap: int) -> int:
    """Shared window count for width-``w`` slabs: fill a ~``flops_cap``
    sort area (so per-slab memory is budget-bound regardless of row
    weights), but never allocate more windows than the class has rows;
    gran-rounded so every window buffer is whole 32768-element blocks."""
    gran = _width_gran(w)
    sp = max(min(flops_cap // w, pad_cap // w), 1)
    sp = min(sp, -(-n_class // gran) * gran)
    # NOTE: pad_cap is approximate, not a hard bound — the gran round-up
    # below can overshoot it by up to lcm(w, 32768) elements.
    return max(-(-sp // gran) * gran, gran)


def _class_area(w: int, n_class: int, flops_cap: int, pad_cap: int) -> int:
    """Total allocated (padded) elements for a class of ``n_class`` rows at
    width ``w``: #slabs x shared-s_pad x w, including the partial tail
    slab's sentinel windows."""
    if n_class <= 0:
        return 0
    sp = _spad_for(w, n_class, flops_cap, pad_cap)
    return -(-n_class // sp) * sp * w


def _choose_widths(fl_desc: np.ndarray, cands: list[int], max_widths: int,
                   flops_cap: int, pad_cap: int) -> list[int]:
    """Pick <= ``max_widths`` window widths from ``cands`` minimizing total
    ALLOCATED sort area when every row is assigned the smallest selected
    width STRICTLY greater than its product count (the >= 1
    trailing-sentinel invariant).  The cost of covering a row range with
    one width is :func:`_class_area` — it charges the real shared-shape
    cost (slab quantization + gran rounding + partial tail), not just the
    intrinsic ladder padding.  Small DP, O(K C^2) with C ~ 100."""
    C = len(cands)
    req = np.searchsorted(cands, fl_desc, side="right")  # first cand > fl
    assert req.max(initial=0) < C, "candidate ladder does not cover max row"
    n = np.bincount(req, minlength=C)
    cum = np.cumsum(n)
    jmax = int(req.max(initial=0))
    K = max(min(max_widths, C), 1)
    INF = float("inf")
    f = [[INF] * C for _ in range(K + 1)]
    parent = [[-1] * C for _ in range(K + 1)]

    def seg_cost(ip, i):
        # bins (ip, i] served by width cands[i]; ip == -1 means from 0
        n_seg = int(cum[i] - (cum[ip] if ip >= 0 else 0))
        return float(_class_area(cands[i], n_seg, flops_cap, pad_cap))

    for i in range(C):
        f[1][i] = seg_cost(-1, i)
    for k in range(2, K + 1):
        for i in range(C):
            best, barg = f[k - 1][i], i  # reuse k-1 solution (skip a width)
            for ip in range(i):
                c = f[k - 1][ip] + seg_cost(ip, i)
                if c < best:
                    best, barg = c, ip
            f[k][i] = best
            parent[k][i] = barg
    i = min(range(jmax, C), key=lambda j: f[K][j])
    sel = []
    k = K
    while k >= 1 and i >= 0:
        if not sel or sel[-1] != cands[i]:
            sel.append(cands[i])
        ip = parent[k][i] if k > 1 else -1
        if ip == i:
            k -= 1
            continue
        i = ip
        k -= 1
    return sorted(set(sel))


def seg2_plan(a: SpCOO, b: SpCOO, *, flops_cap: int = 1 << 28,
              pad_cap: int = 1 << 28, flat_max_fl: int = 1 << 9,
              max_widths: int = 20):
    """Host plan for the sorted-row uniform-width pipeline.

    Builds ``a2`` — A with rows permuted by descending product count and
    zero-product rows/entries dropped — plus contiguous slab bounds over the
    sorted row order.  Each slab gets ONE window width ``w`` and a window
    count ``s_pad``; slabs cut when (i) the next row falls below the
    previous ladder width (pad bound), (ii) slab flops would exceed
    ``flops_cap`` (the stream/memory budget), or (iii) padded elements
    would exceed ``pad_cap``.  Rows with fewer than ``flat_max_fl``
    products skip the window machinery entirely and ride the flat two-key
    digest step.

    Compiled-shape discipline (every distinct static shape is one more
    compile): the width ladder is not fixed — ``_choose_widths`` picks
    <= ``max_widths`` widths from a quarter-octave candidate grid by a
    small DP minimizing total padded mass for THIS matrix's row-flops
    distribution, and a normalization pass then forces every slab of one
    width to share a single (s_pad, nnz_cap) pair and every flat slab to
    share one config.  Compiled shapes = selected widths + 1.

    Returns (a2, cfg) where cfg carries bounds, per-slab static configs and
    the shared caps."""
    # every per-slab sort (window batch or flat stream) is bounded by the
    # slab budget; enforce XLA's stable-sort element limit here, not at
    # XLA-error time
    check_sort_limit(flops_cap, "seg2 slab budget")
    m, k = a.shape
    nnz = int(a.nnz)
    b_rp = np.asarray(b.row_ptr()).astype(np.int64)
    arow = np.asarray(a.row)[:nnz]
    acol = np.minimum(np.asarray(a.col)[:nnz], k - 1)
    aval = np.asarray(a.val)[:nnz]
    cnt_e = b_rp[acol + 1] - b_rp[acol]
    rowfl = np.bincount(arow, weights=cnt_e, minlength=m).astype(np.int64)
    live_rows = np.flatnonzero(rowfl > 0)
    order = live_rows[np.argsort(-rowfl[live_rows], kind="stable")]
    R = len(order)
    fl = rowfl[order]  # descending
    newid = np.full(m, -1, np.int64)
    newid[order] = np.arange(R)
    keep = cnt_e > 0
    new_r = newid[arow[keep]].astype(np.int32)
    new_c = acol[keep].astype(np.int32)
    new_v = aval[keep]
    og = np.lexsort((new_c, new_r))
    new_r, new_c, new_v = new_r[og], new_c[og], new_v[og]
    a2 = SpCOO.from_arrays(new_r, new_c, new_v, (m, k),
                           sum_duplicates=False, dtype=a.val.dtype)
    # per-sorted-row entry counts (for per-slab nnz caps)
    epr = np.bincount(new_r, minlength=R).astype(np.int64)
    epr_cum = np.concatenate([[0], np.cumsum(epr)])
    fl_cum = np.concatenate([[0], np.cumsum(fl)])

    min_w = 1 << _MIN_CLS
    # matrix-adaptive width ladder over the heavy (windowed) rows
    heavy = fl[fl >= flat_max_fl]
    n_heavy = int(heavy.size)
    if n_heavy:
        cands, c = [], min_w
        top = int(heavy[0])
        while c <= top:
            cands.extend(c * mlt // 4 for mlt in (4, 5, 6, 7))
            c <<= 1
        cands.append(c)
        cands = sorted({x for x in cands if x >= min_w})
        sel_w = np.asarray(
            _choose_widths(heavy, cands, max_widths, flops_cap, pad_cap),
            np.int64)
        # per-width shared window count, from the FULL class population
        req = np.searchsorted(sel_w, heavy, side="right")
        class_n = np.bincount(req, minlength=len(sel_w))
        spad_w = {int(sel_w[i]): _spad_for(int(sel_w[i]), int(class_n[i]),
                                           flops_cap, pad_cap)
                  for i in range(len(sel_w)) if class_n[i] > 0}
    else:
        sel_w = np.asarray([min_w], np.int64)
        spad_w = {}

    bounds = [0]
    slabs = []
    r = 0
    while r < R:
        f0 = int(fl[r])
        # small rows skip the window machinery: per-window overhead
        # dwarfs their few products, and the flat two-key sort on their
        # short streams is cheap — route every row below flat_max_fl
        # through the flat digest step
        flat = f0 < flat_max_fl
        if flat:
            w = min_w
            # flat slab: every remaining row, cut by the flops budget and
            # clamped at 2^27 products, because the two-key step holds
            # more stream temporaries per product than the window step.
            # Sized for a 16 GB device; ROADMAP C5 derives it from the
            # device's memory.
            flat_cap = min(flops_cap, 1 << 27)
            lim_flops = int(
                np.searchsorted(fl_cum, fl_cum[r] + flat_cap, side="right")
                - 1 - r)
            cnt = max(min(lim_flops, R - r), 1)
            s_pad = cnt
        else:
            wi = int(np.searchsorted(sel_w, f0, side="right"))
            w = int(sel_w[wi])  # smallest selected width strictly > f0
            # rows down to the previous selected width share the class
            w_low = int(sel_w[wi - 1]) if wi > 0 else flat_max_fl
            lim_class = int(np.searchsorted(-fl, -w_low, side="right") - r)
            # fixed-count cut: every slab of this width takes s_pad rows
            # (the shared sort area is ~flops_cap by construction, so the
            # memory budget holds without a per-slab flops bound); only
            # the class tail is partial
            s_pad = spad_w[w]
            cnt = max(min(s_pad, lim_class), 1)
        nnz_s = int(epr_cum[r + cnt] - epr_cum[r])
        fl_s = int(fl_cum[r + cnt] - fl_cum[r])
        slabs.append(dict(
            w=int(w), s_pad=int(s_pad), cnt=int(cnt),
            nnz_cap=_pow4_cap(nnz_s),
            flops=fl_s, padded=fl_s if flat else int(s_pad) * int(w),
            flat=flat,
            flat_stream_cap=stream_capacity(fl_s) if flat else 0,
        ))
        r += cnt
        bounds.append(r)
    # ---- shape-sharing normalization: one compiled shape per width ----
    # (s_pad is already shared per width; share the cheap caps too)
    by_shape = {}
    for sl in slabs:
        by_shape.setdefault(("flat",) if sl["flat"] else (sl["w"],),
                            []).append(sl)
    for key, group in by_shape.items():
        nnz_cap = max(sl["nnz_cap"] for sl in group)
        fsc = max(sl["flat_stream_cap"] for sl in group)
        s_pad = max(sl["s_pad"] for sl in group)
        for sl in group:
            sl["s_pad"] = int(s_pad)
            sl["nnz_cap"] = int(nnz_cap)
            sl["flat_stream_cap"] = int(fsc)
            if not sl["flat"]:
                sl["padded"] = int(s_pad) * int(sl["w"])
    worst_fl = max(s["flops"] for s in slabs)
    stream_cap = stream_capacity(worst_fl)
    padded_total = sum(s["padded"] for s in slabs)
    flops_total = int(fl_cum[-1])
    shapes = sorted({(s["w"], s["s_pad"], s["nnz_cap"], s["flat"],
                      s["flat_stream_cap"])
                     for s in slabs})
    cfg = dict(
        bounds=np.asarray(bounds, np.int32), slabs=slabs,
        stream_cap=int(stream_cap), worst_fl=int(worst_fl),
        padded=int(padded_total), flops=flops_total,
        pad_ratio=padded_total / max(flops_total, 1), shapes=shapes,
    )
    return a2, cfg


@functools.partial(
    jax.jit,
    static_argnames=("sr", "w", "s_pad", "nnz_cap", "stream_cap",
                     "slab_out_cap"),
)
def _seg2_slab_digest_step(
    a2: SpCOO,
    b: SpCOO,
    b_rp,
    bounds,
    s,
    cnt,
    total_lo,
    total_hi,
    checksum,
    truncated,
    sr: Semiring,
    *,
    w: int,
    s_pad: int,
    nnz_cap: int,
    stream_cap: int,
    slab_out_cap: int,
):
    """One sorted-row uniform-width slab: expand, cut each row's run into a
    ``w``-wide window, ONE (s_pad, w) batched within-row sort by column,
    masked compress, digest fold.  All ``cnt`` live windows are contiguous
    local rows [0, cnt); ``s_pad - cnt`` trailing windows are
    all-sentinel."""
    k = a2.shape[1]
    n = b.shape[1]
    sub, _ = _slab_extract(a2, k, bounds, s, span_cap=s_pad,
                                 slab_nnz_cap=nnz_cap)
    with jax.named_scope("seg2_expand"):
        _, colstream, valstream, _ = expand_products(
            sub.row, sub.col, sub.val, sub.mask(), b.col, b.val,
            b_rp[:-1], b_rp[1:], sr, stream_cap, (s_pad, n))
        rowfl, row_start = _row_flops_exact(sub, b_rp, s_pad)
        live = jnp.arange(s_pad, dtype=jnp.int32) < cnt
        lens = jnp.where(live, rowfl[:s_pad], 0)
        j = jnp.arange(w, dtype=jnp.int32)[None, :]
        keep = j < lens[:, None]
        idx = jnp.where(keep, row_start[:s_pad, None] + j, 0)
        col2d = jnp.where(keep, colstream[idx], _SENT)
        val2d = jnp.where(keep, valstream[idx], 0)
    with jax.named_scope("seg2_sort"):
        col2d, val2d = jax.lax.sort((col2d, val2d), dimension=1, num_keys=1)
    with jax.named_scope("seg2_compress"):
        rows = jnp.broadcast_to(jnp.arange(s_pad, dtype=jnp.int32)[:, None],
                                (s_pad, w))
        col = col2d.reshape(-1)
        c = compress_sorted_masked(rows.reshape(-1), col, val2d.reshape(-1),
                                   col != _SENT, (s_pad, n), sr=sr,
                                   out_capacity=slab_out_cap)
    return _fold_digest(c, total_lo, total_hi, checksum, truncated,
                        slab_out_cap)


@functools.partial(
    jax.jit,
    static_argnames=("sr", "span_cap", "nnz_cap", "stream_cap",
                     "slab_out_cap"),
)
def _seg2_flat_digest_step(
    a2: SpCOO,
    b: SpCOO,
    b_rp,
    bounds,
    s,
    total_lo,
    total_hi,
    checksum,
    truncated,
    sr: Semiring,
    *,
    span_cap: int,
    nnz_cap: int,
    stream_cap: int,
    slab_out_cap: int,
):
    """One flat slab: expand, sort the whole stream by (row, col) as two
    int32 keys, compress, digest fold.  Rows are slab-local and never
    packed into one key, so there is no limit on (rows+1)*(n+1)."""
    k = a2.shape[1]
    n = b.shape[1]
    sub, _ = _slab_extract(a2, k, bounds, s, span_cap=span_cap,
                                 slab_nnz_cap=nnz_cap)
    with jax.named_scope("seg2_expand"):
        i, j, v, total = expand_products(
            sub.row, sub.col, sub.val, sub.mask(), b.col, b.val,
            b_rp[:-1], b_rp[1:], sr, stream_cap, (span_cap, n))
    with jax.named_scope("seg2_sort"):
        i, j, v = jax.lax.sort((i, j, v), num_keys=2)
    with jax.named_scope("seg2_compress"):
        c = compress_sorted(i, j, v, total, (span_cap, n), sr=sr,
                            out_capacity=slab_out_cap)
    return _fold_digest(c, total_lo, total_hi, checksum, truncated,
                        slab_out_cap)


def seg2_prepare(a: SpCOO, b: SpCOO, *, flops_cap: int = 1 << 28,
                 pad_cap: int = 1 << 28, slab_out_cap: int | None = None,
                 max_widths: int = 20):
    """Hoistable state for the sorted-row uniform-width digest pipeline:
    (a2, cfg, b_rp, bounds_dev, slab_out_cap).

    ``max_widths`` trades compiled shapes (one per width, plus one for the
    flat slabs) for window padding."""
    a2, cfg = seg2_plan(a, b, flops_cap=flops_cap, pad_cap=pad_cap,
                        max_widths=max_widths)
    if slab_out_cap is None:
        # strictly above any slab's product count: a slab whose products
        # are all distinct fills worst_fl entries, which must not read as
        # truncation (nnz == capacity)
        slab_out_cap = round_capacity_frac(max(cfg["worst_fl"] + 1, 2048))
    return (a2, cfg, b.row_ptr(), jnp.asarray(cfg["bounds"]), slab_out_cap)


def seg2_step(b, prep, s, state, sr: Semiring = PLUS_TIMES):
    """One slab step on hoisted ``prep`` state (host loop drives ``s``)."""
    a2, cfg, b_rp, bounds_dev, slab_out_cap = prep
    sl = cfg["slabs"][s]
    if sl["flat"]:
        return _seg2_flat_digest_step(
            a2, b, b_rp, bounds_dev, jnp.asarray(s, jnp.int32), *state, sr,
            span_cap=sl["s_pad"], nnz_cap=sl["nnz_cap"],
            stream_cap=sl["flat_stream_cap"], slab_out_cap=slab_out_cap,
        )
    return _seg2_slab_digest_step(
        a2, b, b_rp, bounds_dev, jnp.asarray(s, jnp.int32),
        jnp.asarray(sl["cnt"], jnp.int32), *state, sr,
        w=sl["w"], s_pad=sl["s_pad"], nnz_cap=sl["nnz_cap"],
        stream_cap=cfg["stream_cap"], slab_out_cap=slab_out_cap,
    )


def spgemm_streamed_seg2(
    a: SpCOO,
    b: SpCOO,
    sr: Semiring = PLUS_TIMES,
    *,
    flops_cap: int = 1 << 28,
    pad_cap: int = 1 << 28,
    slab_out_cap: int | None = None,
    max_widths: int = 20,
):
    """Slab-streamed digest SpGEMM: every product formed, every duplicate
    merged, per-slab digest fold; C's rows are visited in descending-flops
    order (the digest is row-permutation invariant).  Returns (nnz_total,
    checksum, truncated)."""
    prep = seg2_prepare(a, b, flops_cap=flops_cap, pad_cap=pad_cap,
                        slab_out_cap=slab_out_cap, max_widths=max_widths)
    state = seg_zero_state()
    for s in range(len(prep[1]["slabs"])):
        state = seg2_step(b, prep, s, state, sr)
    total_lo, total_hi, checksum, truncated = state
    total = int(total_lo) + (int(total_hi) << 16)
    return total, checksum, truncated
