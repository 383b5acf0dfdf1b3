"""CLI smoke tests over small graphs in tests/data; the expected values are
recomputed from each file's triples with numpy/scipy."""

import os

import numpy as np
import pytest

from combblas_tpu.cli import main

DATA = os.path.join(os.path.dirname(__file__), "data")
SEVEN = os.path.join(DATA, "sevenvertex.mtx")
SMALL = os.path.join(DATA, "small_nonsym.mtx")


def _dense(path, skip):
    t = np.loadtxt(path, comments="%", skiprows=skip, ndmin=2)
    m, n = (int(x) for x in np.loadtxt(path, comments="%", skiprows=skip - 1,
                                       max_rows=1)[:2])
    d = np.zeros((m, n))
    d[t[:, 0].astype(int) - 1, t[:, 1].astype(int) - 1] = t[:, 2]
    return d


def test_cli_bfs(capsys):
    from scipy.sparse.csgraph import breadth_first_order

    d = _dense(SEVEN, 3)
    reach = len(breadth_first_order(d, 2, directed=True,
                                    return_predecessors=False))
    main(["bfs", SEVEN, "--root", "2"])
    assert f"visited {reach} " in capsys.readouterr().out


def test_cli_cc(capsys):
    from scipy.sparse.csgraph import connected_components

    ncomp, _ = connected_components(_dense(SEVEN, 3), directed=False)
    main(["cc", SEVEN])
    out = capsys.readouterr().out
    assert f"{ncomp} components" in out


def test_cli_spgemm(tmp_path, capsys):
    d = _dense(SEVEN, 3)
    nnz = int(((d @ d) != 0).sum())
    out = str(tmp_path / "c.mtx")
    main(["spgemm", SEVEN, "-o", out])
    assert f"nnz {nnz} " in capsys.readouterr().out
    from combblas_tpu.io.mtx import read_mtx

    c = read_mtx(out)
    assert int(c.nnz) == nnz


def test_cli_headerless_matrix(capsys):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_bipartite_matching

    d = _dense(SMALL, 1)
    match = maximum_bipartite_matching(sp.csr_matrix(d), perm_type="column")
    main(["match", SMALL, "--max"])
    assert f"cardinality {int((match >= 0).sum())}" in capsys.readouterr().out


def test_cli_gen_convert(tmp_path, capsys):
    b = str(tmp_path / "g.bin")
    m = str(tmp_path / "g.mtx")
    main(["gen", "--scale", "6", "-o", b])
    main(["convert", b, "-o", m])
    from combblas_tpu.io.binary import read_binary
    from combblas_tpu.io.mtx import read_mtx

    np.testing.assert_allclose(
        np.asarray(read_binary(b).to_dense()),
        np.asarray(read_mtx(m).to_dense()),
        rtol=1e-6,
    )


def test_labeled_tuples(tmp_path):
    from combblas_tpu.io.labels import read_labeled_tuples, write_labeled_tuples

    p = str(tmp_path / "g.txt")
    with open(p, "w") as f:
        f.write("protA protB 1.5\nprotB protC 2.0\nprotC protA 0.5\n")
    a, labels = read_labeled_tuples(p)
    assert labels == ["protA", "protB", "protC"]
    assert int(a.nnz) == 3
    d = np.asarray(a.to_dense())
    assert d[0, 1] == 1.5 and d[1, 2] == 2.0 and d[2, 0] == 0.5
    q = str(tmp_path / "out.txt")
    write_labeled_tuples(q, a, labels)
    b, labels2 = read_labeled_tuples(q)
    np.testing.assert_allclose(np.asarray(b.to_dense()), d)
