"""Write the exact R-MAT A an earlier version of the bench multiplied, as binary triples for
the reference-kernel baseline harness (ref_local_spgemm.cpp).  Runs on CPU so
the device stays free."""
import struct
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, "/root/repo")
from combblas_tpu.gen.rmat import rmat_matrix


def main():
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    out = sys.argv[2] if len(sys.argv) > 2 else f"/tmp/rmat_s{scale}.bin"
    a = rmat_matrix(jax.random.PRNGKey(42), scale=scale, edgefactor=16)
    nnz = int(a.nnz)
    r = np.asarray(a.row)[:nnz].astype(np.int64)
    c = np.asarray(a.col)[:nnz].astype(np.int64)
    v = np.asarray(a.val)[:nnz].astype(np.float64)
    m, n = a.shape
    with open(out, "wb") as f:
        f.write(struct.pack("<qqq", m, n, nnz))
        rec = np.empty((nnz, 3), np.int64)
        rec[:, 0] = r
        rec[:, 1] = c
        rec[:, 2] = v.view(np.int64) if False else 0
        # interleave (row, col, valbits)
        rec[:, 2] = v.view(np.int64)
        rec.tofile(f)
    print(f"wrote {out}: m={m} n={n} nnz={nnz}")


if __name__ == "__main__":
    main()
