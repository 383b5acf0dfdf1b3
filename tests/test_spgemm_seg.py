"""Sorted-row streamed ESC pipeline (seg2) — digest correctness against
dense references and the materialized SpGEMM, on the CPU mesh.

Mirrors the reference's cross-implementation equivalence testing style
(``MultTest.cpp:120-230``: every new execution variant is checked against
an independently computed product)."""

import numpy as np
import pytest

from combblas_tpu.ops.coo import SpCOO
from combblas_tpu.ops.spgemm import spgemm_auto
from combblas_tpu.ops.spgemm_seg import seg2_plan, spgemm_streamed_seg2
from combblas_tpu.semiring import PLUS_TIMES


def _rand(m, k, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((m, k)) < density) * rng.random((m, k))
    return d.astype(np.float32)


def _skewed(seed, m=200):
    # power-law-ish skew: a few hub rows with large windows, many tiny rows
    rng = np.random.default_rng(seed)
    k = n = m
    ad = np.zeros((m, k), np.float32)
    for i in range(m):
        deg = min(int(rng.pareto(0.7) + 1), k)
        cols = rng.choice(k, size=deg, replace=False)
        ad[i, cols] = rng.random(deg).astype(np.float32) + 0.1
    bd = (rng.random((k, n)) < 0.2).astype(np.float32) * 0.5
    return ad, bd


@pytest.mark.parametrize("flops_cap", [1 << 12, 1 << 13])
def test_seg2_skewed_matches_spgemm(flops_cap):
    """Skewed rows (hub windows and many flat rows) digest to the
    materialized product's (nnz, value-sum)."""
    ad, bd = _skewed(7)
    a = SpCOO.from_dense(ad)
    b = SpCOO.from_dense(bd)
    nnz_2, cks_2, tr_2 = spgemm_streamed_seg2(
        a, b, PLUS_TIMES, flops_cap=flops_cap, pad_cap=1 << 16)
    c = spgemm_auto(a, b)
    nnz_c = int(c.nnz)
    assert not bool(tr_2)
    assert nnz_2 == nnz_c
    np.testing.assert_allclose(float(cks_2),
                               float(np.asarray(c.val)[:nnz_c].sum()),
                               rtol=1e-5)


def test_seg2_single_slab_tiny():
    ad = np.array([[1.0, 2.0, 0.0], [0.0, 3.0, 4.0], [5.0, 0.0, 6.0]],
                  np.float32)
    a = SpCOO.from_dense(ad)
    nnz, cks, trunc = spgemm_streamed_seg2(a, a, PLUS_TIMES)
    ref = ad @ ad
    assert nnz == int((ref != 0).sum())
    np.testing.assert_allclose(cks, ref.sum(), rtol=1e-5)
    assert not bool(trunc)


def test_seg2_rows_at_ladder_widths():
    """Rows whose product counts equal ladder candidates (512 and 1024)
    get a strictly wider window, so every window keeps a trailing
    sentinel, and the digest stays exact."""
    k = n = 2048
    rng = np.random.default_rng(4)
    bd = np.zeros((k, n), np.float32)
    for r in range(16):  # B rows 0..15 hold 128 entries each
        bd[r, rng.choice(n, 128, replace=False)] = 1.0
    ad = np.zeros((40, k), np.float32)
    ad[0, :8] = 1.0     # 8 x 128 = 1024 products
    ad[1, 8:12] = 2.0   # 4 x 128 = 512 products
    ad[np.arange(2, 40), 16 + np.arange(38)] = 1.0  # B rows without entries
    ad[5:, 12] = 0.5    # 128 products each (flat rows)
    a = SpCOO.from_dense(ad)
    b = SpCOO.from_dense(bd)
    a2, cfg = seg2_plan(a, b, flops_cap=1 << 12, pad_cap=1 << 15)
    fl = np.sort((ad != 0).astype(np.int64) @ (bd != 0).sum(axis=1))[::-1]
    for s, sl in enumerate(cfg["slabs"]):
        if not sl["flat"]:
            assert sl["w"] > fl[cfg["bounds"][s]]
    assert not cfg["slabs"][0]["flat"] and cfg["slabs"][0]["w"] > 1024
    nnz, cks, trunc = spgemm_streamed_seg2(a, b, PLUS_TIMES,
                                           flops_cap=1 << 12,
                                           pad_cap=1 << 15)
    ref = ad.astype(np.float64) @ bd
    assert not bool(trunc)
    assert nnz == int((ref != 0).sum())
    np.testing.assert_allclose(cks, ref.sum(), rtol=1e-5)


def test_seg2_flat_slab_beyond_packed_key_range():
    """A flat slab whose (rows+1)*(n+1) exceeds 2^31 — no packed int32 key
    could hold it — digests exactly through the two-key sort."""
    rng = np.random.default_rng(9)
    m = k = 64
    n = 1 << 28
    arow = np.repeat(np.arange(m), 3)
    acol = rng.integers(0, k, len(arow))
    brow = np.repeat(np.arange(k), 4)
    bcol = rng.integers(0, n, len(brow))
    bcol[::4] = 17  # shared columns make duplicates across products
    a = SpCOO.from_arrays(arow, acol, np.ones(len(arow)), (m, k))
    b = SpCOO.from_arrays(brow, bcol, np.full(len(brow), 0.5), (k, n))
    a2, cfg = seg2_plan(a, b)
    assert all(sl["flat"] for sl in cfg["slabs"])
    assert (cfg["slabs"][0]["s_pad"] + 1) * (n + 1) > 2 ** 31
    nnz, cks, trunc = spgemm_streamed_seg2(a, b, PLUS_TIMES)
    ar, ac, av = (np.asarray(x)[: int(a.nnz)] for x in (a.row, a.col, a.val))
    br, bc, bv = (np.asarray(x)[: int(b.nnz)] for x in (b.row, b.col, b.val))
    keys, prods = [], []
    for i, kk, va in zip(ar, ac, av):
        sel = br == kk
        keys.append(i.astype(np.int64) * n + bc[sel])
        prods.append(va * bv[sel])
    keys = np.concatenate(keys)
    assert not bool(trunc)
    assert nnz == len(np.unique(keys))
    np.testing.assert_allclose(cks, np.concatenate(prods).sum(), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("density", [0.04, 0.15])
def test_seg2_digest_matches_dense(seed, density):
    from combblas_tpu.ops.spgemm_seg import spgemm_streamed_seg2

    m, k, n = 96, 80, 64
    ad = _rand(m, k, density, seed)
    bd = _rand(k, n, density, seed + 10)
    a = SpCOO.from_dense(ad)
    b = SpCOO.from_dense(bd)
    # tiny budgets force several slabs + at least one mid-class cut
    nnz, cks, trunc = spgemm_streamed_seg2(
        a, b, PLUS_TIMES, flops_cap=1 << 12, pad_cap=1 << 16)
    ref = ad.astype(np.float64) @ bd.astype(np.float64)
    assert not bool(trunc)
    assert nnz == int((ref != 0).sum())
    np.testing.assert_allclose(cks, ref.sum(), rtol=1e-4)


@pytest.mark.parametrize("max_widths", [1, 3, 8])
def test_seg2_max_widths_ladders_agree(max_widths):
    """The width-ladder size is a padding/compile tradeoff, never a
    correctness knob: digests must match across ladder choices."""
    from combblas_tpu.ops.spgemm_seg import spgemm_streamed_seg2

    rng = np.random.default_rng(11)
    m = k = n = 120
    ad = np.zeros((m, k), np.float32)
    for i in range(m):
        deg = min(int(rng.pareto(0.7) + 1), k)
        cols = rng.choice(k, size=deg, replace=False)
        ad[i, cols] = rng.random(deg).astype(np.float32) + 0.1
    bd = (rng.random((k, n)) < 0.2).astype(np.float32) * 0.5
    a = SpCOO.from_dense(ad)
    b = SpCOO.from_dense(bd)
    nnz, cks, trunc = spgemm_streamed_seg2(
        a, b, PLUS_TIMES, flops_cap=1 << 12, pad_cap=1 << 16,
        max_widths=max_widths)
    ref = ad.astype(np.float64) @ bd.astype(np.float64)
    assert not bool(trunc)
    assert nnz == int((ref != 0).sum())
    np.testing.assert_allclose(float(cks), ref.sum(), rtol=1e-4)


def test_seg2_flat_slab_flops_clamped():
    """Flat (two-key) slabs are cut at <= 2^27 products regardless of
    flops_cap: the two-key digest step holds more temporaries per product
    than the window step, and the clamp keeps it within a 16 GB device."""
    from combblas_tpu.ops.spgemm_seg import seg2_plan

    rng = np.random.default_rng(5)
    m = k = n = 400
    ad = (rng.random((m, k)) < 0.15).astype(np.float32)
    bd = (rng.random((k, n)) < 0.15).astype(np.float32)
    a = SpCOO.from_dense(ad)
    b = SpCOO.from_dense(bd)
    # a giant budget (largest the sort-limit guard allows) would put every
    # row in one flat slab without the clamp
    a2, cfg = seg2_plan(a, b, flops_cap=1 << 30, pad_cap=1 << 30,
                        flat_max_fl=1 << 20)
    assert all(sl["flat"] for sl in cfg["slabs"])
    for sl in cfg["slabs"]:
        assert sl["flops"] <= (1 << 27)
        assert sl["flat_stream_cap"] <= (1 << 27) + 32768


def test_seg2_plan_invariants():
    """Slab bounds cover all live rows; counts/padding consistent; every
    slab's width strictly exceeds its heaviest row's product count."""
    from combblas_tpu.ops.spgemm_seg import seg2_plan

    rng = np.random.default_rng(3)
    m = k = n = 300
    ad = (rng.random((m, k)) < 0.05).astype(np.float32)
    ad[5] = (rng.random(k) < 0.8)  # hub row
    bd = (rng.random((k, n)) < 0.1).astype(np.float32)
    a = SpCOO.from_dense(ad)
    b = SpCOO.from_dense(bd)
    a2, cfg = seg2_plan(a, b, flops_cap=1 << 12, pad_cap=1 << 15)
    bounds = cfg["bounds"]
    assert bounds[0] == 0
    rowfl_ref = (ad @ (bd != 0).astype(np.int64)).sum(axis=1)
    assert bounds[-1] == int((rowfl_ref > 0).sum())
    fl_sorted = np.sort(rowfl_ref[rowfl_ref > 0])[::-1]
    for i, sl in enumerate(cfg["slabs"]):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        assert sl["cnt"] == hi - lo
        assert sl["s_pad"] >= sl["cnt"]
        # window buffers are whole 32768-element blocks; flat slabs have
        # no window buffer (they sort the raw stream, sized by
        # flat_stream_cap which is itself 32768-granular)
        assert sl["flat"] or (sl["s_pad"] * sl["w"]) % 32768 == 0
        if sl["flat"]:
            # flat slabs take every row below the flat threshold; no
            # window/sentinel invariant (they sort the raw stream)
            assert fl_sorted[lo] < 1 << 9
        else:
            assert sl["w"] > fl_sorted[lo]  # strict: >= 1 trailing sentinel
        assert sl["flops"] == int(fl_sorted[lo:hi].sum())
