"""Graph applications vs reference implementations on small graphs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from combblas_tpu import SpCOO
from combblas_tpu.models.bfs import bfs_local, bfs_dist, validate_bfs
from combblas_tpu.models.cc import count_components, fastsv_local, fastsv_dist
from combblas_tpu.parallel.grid import ProcGrid
from combblas_tpu.parallel.dist import DistSpMat
from tests.test_coo import rand_sparse


def ring_graph(n):
    d = np.zeros((n, n), np.float32)
    for i in range(n):
        d[i, (i + 1) % n] = 1.0
        d[(i + 1) % n, i] = 1.0
    return d


def two_components(n):
    """Two cliques, no bridge."""
    d = np.zeros((n, n), np.float32)
    h = n // 2
    d[:h, :h] = 1.0
    d[h:, h:] = 1.0
    np.fill_diagonal(d, 0.0)
    return d


def bfs_levels_reference(d, root):
    n = d.shape[0]
    lev = np.full(n, -1)
    lev[root] = 0
    frontier = [root]
    depth = 0
    while frontier:
        depth += 1
        nxt = []
        for u in frontier:
            for v in np.nonzero(d[u])[0]:
                if lev[v] < 0:
                    lev[v] = depth
                    nxt.append(v)
        frontier = nxt
    return lev


def test_bfs_local_ring():
    d = ring_graph(12)
    parents, levels = bfs_local(SpCOO.from_dense(d), 0)
    assert validate_bfs(d, 0, parents, levels)
    np.testing.assert_array_equal(np.asarray(levels), bfs_levels_reference(d, 0))


def test_bfs_local_random():
    d = (rand_sparse(30, 30, 0.08, seed=60) != 0).astype(np.float32)
    d = np.maximum(d, d.T)
    parents, levels = bfs_local(SpCOO.from_dense(d), 3)
    assert validate_bfs(d, 3, parents, levels)
    np.testing.assert_array_equal(np.asarray(levels), bfs_levels_reference(d, 3))


def test_bfs_dist_matches_local():
    d = (rand_sparse(24, 24, 0.1, seed=61) != 0).astype(np.float32)
    d = np.maximum(d, d.T)
    g = ProcGrid.make(2, 2, devices=jax.devices()[:4])
    A = DistSpMat.from_local(SpCOO.from_dense(d), g)
    pd, ld = bfs_dist(A, 0)
    pl, ll = bfs_local(SpCOO.from_dense(d), 0)
    np.testing.assert_array_equal(np.asarray(ld)[:24], np.asarray(ll))
    assert validate_bfs(d, 0, np.asarray(pd)[:24], np.asarray(ld)[:24])


def test_fastsv_components():
    d = two_components(16)
    labels = fastsv_local(SpCOO.from_dense(d))
    assert count_components(labels) == 2
    l = np.asarray(labels)
    assert np.all(l[:8] == l[0]) and np.all(l[8:] == l[8]) and l[0] != l[8]


def test_fastsv_ring_single_component():
    d = ring_graph(17)
    labels = fastsv_local(SpCOO.from_dense(d))
    assert count_components(labels) == 1


def test_fastsv_dist_matches_local():
    d = two_components(20)
    g = ProcGrid.make(2, 2, devices=jax.devices()[:4])
    A = DistSpMat.from_local(SpCOO.from_dense(d), g)
    labels = fastsv_dist(A)
    assert count_components(labels, n=20) == 2


def test_mcl_two_cliques():
    from combblas_tpu.models.mcl import MCLParams, mcl_local

    d = two_components(12)
    labels, iters = mcl_local(
        SpCOO.from_dense(d), MCLParams(inflation=2.0, max_iters=30)
    )
    l = np.asarray(labels)[:12]
    # two cliques must end in two distinct clusters
    assert len(np.unique(l)) == 2
    assert np.all(l[:6] == l[0]) and np.all(l[6:] == l[6])


def test_indexing_spref():
    from combblas_tpu.ops.indexing import spref, spref_gather, spasgn

    d = rand_sparse(10, 12, 0.4, seed=62)
    a = SpCOO.from_dense(d)
    ri = np.asarray([2, 5, 7])
    ci = np.asarray([0, 3, 4, 11])
    sub = spref(a, ri, ci)
    np.testing.assert_allclose(
        np.asarray(sub.to_dense()), d[np.ix_(ri, ci)], rtol=1e-5
    )
    sub2 = spref_gather(
        a, jnp.asarray(ri), jnp.asarray(ci), out_rows=3, out_cols=4
    )
    np.testing.assert_allclose(
        np.asarray(sub2.to_dense()), d[np.ix_(ri, ci)], rtol=1e-5
    )


def test_indexing_spasgn():
    from combblas_tpu.ops.indexing import spasgn

    d = rand_sparse(9, 9, 0.4, seed=63)
    b = rand_sparse(3, 3, 0.8, seed=64)
    ri = np.asarray([1, 4, 6])
    ci = np.asarray([0, 2, 8])
    out = spasgn(SpCOO.from_dense(d), ri, ci, SpCOO.from_dense(b))
    expect = d.copy()
    expect[np.ix_(ri, ci)] = b
    np.testing.assert_allclose(np.asarray(out.to_dense()), expect, rtol=1e-5)


def test_bfs_dir_opt_matches_top_down():
    from combblas_tpu.models.bfs import bfs_dir_opt_local

    d = (rand_sparse(40, 40, 0.12, seed=65) != 0).astype(np.float32)
    d = np.maximum(d, d.T)
    p1, l1 = bfs_local(SpCOO.from_dense(d), 0)
    p2, l2 = bfs_dir_opt_local(SpCOO.from_dense(d), 0)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
    assert validate_bfs(d, 0, p2, l2)


def test_bfs_dir_opt_dist_matches_dist():
    """Distributed direction-optimizing BFS (DirOptBFS.cpp:398 +
    BFSFriends.h:458): levels must equal plain dist BFS; dense-enough graphs
    force the pull branch."""
    from combblas_tpu.models.bfs import bfs_dir_opt_dist

    rng = np.random.default_rng(21)
    n = 48
    d = rand_sparse(n, n, 0.15, seed=22)
    d = np.maximum(d, d.T)  # symmetric: frontier grows fast -> pull kicks in
    a = SpCOO.from_dense(d)
    g = ProcGrid.make()
    A = DistSpMat.from_local(a, g)
    p1, l1 = bfs_dist(A, 0)
    p2, l2 = bfs_dir_opt_dist(A, 0)
    np.testing.assert_array_equal(np.asarray(l1)[:n], np.asarray(l2)[:n])
    assert validate_bfs(d, 0, np.asarray(p2)[:n], np.asarray(l2)[:n])
    # and against the host reference levels
    np.testing.assert_array_equal(np.asarray(l2)[:n], bfs_levels_reference(d, 0))


def test_bfs_dir_opt_dist_ring():
    """Sparse ring keeps the frontier tiny -> exercises the push branch under
    the same driver."""
    from combblas_tpu.models.bfs import bfs_dir_opt_dist

    n = 32
    d = ring_graph(n)
    A = DistSpMat.from_local(SpCOO.from_dense(d), ProcGrid.make())
    p, l = bfs_dir_opt_dist(A, 3)
    np.testing.assert_array_equal(np.asarray(l)[:n], bfs_levels_reference(d, 3))


def test_bfs_push_matches_while_loop():
    """Push BFS (frontier expansion) levels match the while_loop BFS
    and validate Graph500-style (MultTest-style cross-implementation
    equivalence, ``TopDownBFS.cpp:448-457``)."""
    import jax
    import numpy as np
    from combblas_tpu.gen.rmat import rmat_matrix
    from combblas_tpu.models.bfs import (
        bfs_local,
        bfs_push_local,
        validate_bfs,
    )

    a = rmat_matrix(jax.random.PRNGKey(9), scale=10, edgefactor=8,
                    symmetrize=True, remove_self_loops=True)
    p1, l1 = bfs_local(a, 3)
    p2, l2 = bfs_push_local(a, 3)
    l1, l2 = np.asarray(l1), np.asarray(l2)
    assert (l1 == l2).all()
    assert validate_bfs(a.to_dense(), 3, np.asarray(p2), l2)


def test_bfs_batch_pull_matches_while_loop():
    """Device-resident batched pull BFS: levels match the while_loop BFS
    for every root in one dispatch, parents Graph500-validate."""
    import jax
    import numpy as np
    from combblas_tpu.gen.rmat import rmat_matrix
    from combblas_tpu.models.bfs import (
        bfs_batch_pull,
        bfs_local,
        validate_bfs,
    )

    a = rmat_matrix(jax.random.PRNGKey(9), scale=9, edgefactor=8,
                    symmetrize=True, remove_self_loops=True)
    roots = [3, 17, 101]
    P, L = bfs_batch_pull(a, roots)
    P, L = np.asarray(P), np.asarray(L)
    ad = np.asarray(a.to_dense())
    for i, r in enumerate(roots):
        _, l1 = bfs_local(a, r)
        assert (np.asarray(l1) == L[i]).all()
        assert validate_bfs(ad, r, P[i], L[i])


def test_bfs_push_small_graph():
    """Regression: push BFS crashed on graphs with n < 1024 because the
    frontier cap was floored at 1024 > n."""
    import numpy as np
    from combblas_tpu.models.bfs import bfs_push_local, validate_bfs
    from combblas_tpu.ops.coo import SpCOO

    n = 12  # path graph 0-1-2-...-11
    d = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        d[i, i + 1] = d[i + 1, i] = 1.0
    a = SpCOO.from_dense(d)
    p, l = bfs_push_local(a, 0)
    l = np.asarray(l)
    assert (l == np.arange(n)).all()
    assert validate_bfs(d, 0, np.asarray(p), l)


def test_bfs_push_isolated_root():
    """A root with no edges: one level with an empty expansion stream, the
    root alone visited."""
    import numpy as np
    from combblas_tpu.models.bfs import bfs_push_local
    from combblas_tpu.ops.coo import SpCOO

    n = 10
    d = np.zeros((n, n), np.float32)
    for i in range(1, n - 1):
        d[i, i + 1] = d[i + 1, i] = 1.0
    p, l = bfs_push_local(SpCOO.from_dense(d), 0)
    expect = np.full(n, -1)
    expect[0] = 0
    np.testing.assert_array_equal(np.asarray(l), expect)
    np.testing.assert_array_equal(np.asarray(p), expect)
