"""combblas_tpu — a combinatorial-BLAS / GraphBLAS framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of CombBLAS
(reference: huanghua1994/CombBLAS-SpMM-test): semiring-parameterized sparse
linear algebra (SpGEMM, SpMV/SpMSpV, SpMM, elementwise, reductions, indexing)
over 2D/3D device meshes, plus the graph algorithms built on those primitives
(BFS, connected components, Markov clustering, betweenness centrality,
bipartite matching, RCM ordering).

Layer map (mirrors SURVEY.md §1):
  L0  parallel.grid      — ProcGrid over jax.sharding.Mesh (CommGrid/CommGrid3D)
  L1  ops.*              — local padded-COO kernels (SpDCCols/mtSpGEMM/SpImpl)
  L2  parallel.dist      — DistSpMat / DistVec (SpParMat / FullyDistVec)
  L3  parallel.{summa,spmv,...} — distributed algorithms (ParFriends)
  L4  models.*           — applications (Applications/)
"""

from combblas_tpu.semiring import (
    MAX_FIRST,
    MAX_PLUS,
    MAX_SECOND,
    MAX_TIMES,
    MIN_PLUS,
    MIN_SECOND,
    OR_AND,
    PLUS_TIMES,
    Semiring,
    get_semiring,
)
from combblas_tpu.ops.coo import SpCOO, find, merge, sort_coo
from combblas_tpu.ops.spgemm import spgemm_auto
from combblas_tpu.ops.spmv import spmm, spmsv_masked, spmv, spmv_transpose

__version__ = "0.1.0"


def square(a: SpCOO, sr=PLUS_TIMES, **kw) -> SpCOO:
    """A² convenience (``SpParMat::Square``, ``SpParMat.cpp:3456``)."""
    return spgemm_auto(a, a, sr, **kw)
