"""Semiring algebra for sparse operations.

Redesign of the reference's semiring layer
(``include/CombBLAS/Semirings.h:51-259`` and ``Operations.h:46-286``): instead of
C++ functors bound to MPI_Op handles, a semiring here is a small frozen dataclass
whose *additive* operation is restricted to one of the three reduction kinds XLA
can execute as segment reductions and mesh collectives (``sum``/``min``/``max``),
and whose *multiplicative* operation is an arbitrary elementwise jnp-traceable
callable.  That restriction is what lets every distributed reduce ride
``jax.lax.psum``/``pmin``/``pmax`` over the mesh with no user-defined-op machinery
(the reference needs an ``MPIOp`` cache, ``MPIOp.h:67-109``; we need nothing).

Semirings are hashable and compare by name, so they can be passed as static jit
arguments without retracing churn.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp
import numpy as np

__all__ = [
    "Semiring",
    "PLUS_TIMES",
    "MIN_PLUS",
    "MAX_PLUS",
    "MAX_TIMES",
    "OR_AND",
    "MAX_SECOND",
    "MIN_SECOND",
    "MAX_FIRST",
    "get_semiring",
]

# Additive identity per reduction kind, as a function of dtype.


def _add_identity(add_kind: str, dtype) -> np.generic:
    dtype = jnp.dtype(dtype)
    if add_kind == "sum":
        return np.zeros((), dtype)
    if add_kind == "min":
        if jnp.issubdtype(dtype, jnp.floating):
            return np.array(np.inf, dtype)
        return np.array(jnp.iinfo(dtype).max, dtype)
    if add_kind == "max":
        if jnp.issubdtype(dtype, jnp.floating):
            return np.array(-np.inf, dtype)
        if dtype == jnp.bool_:
            return np.zeros((), dtype)
        return np.array(jnp.iinfo(dtype).min, dtype)
    raise ValueError(f"unknown add_kind {add_kind!r}")


@dataclasses.dataclass(frozen=True)
class Semiring:
    """An algebraic semiring ``(add, mul, 0)``.

    ``add_kind`` must be one of ``sum | min | max`` — every additive reduction
    in the library (local segment merges, SUMMA stage accumulation, mesh-axis
    psum/pmin/pmax) is derived from it.  ``mul`` is any binary jnp-traceable
    elementwise function.

    Mirrors the capability of the reference's ``Semirings.h`` ring templates
    (``PlusTimesSRing`` at ``Semirings.h:213``, ``MinPlusSRing`` at ``:236``,
    ``Select2ndSRing`` at ``:144``, ``SelectMaxSRing`` at ``:166``,
    ``BoolCopy2ndSRing`` at ``:51``), re-expressed for XLA.
    """

    name: str
    add_kind: str  # 'sum' | 'min' | 'max'
    mul: Callable = dataclasses.field(compare=False, hash=False)

    def __post_init__(self):
        if self.add_kind not in ("sum", "min", "max"):
            raise ValueError(f"add_kind must be sum|min|max, got {self.add_kind}")

    # -- additive side ----------------------------------------------------
    def zero(self, dtype) -> np.generic:
        """Additive identity for ``dtype`` (used as the padding value)."""
        return _add_identity(self.add_kind, dtype)

    def add(self, a, b):
        if self.add_kind == "sum":
            return a + b
        if self.add_kind == "min":
            return jnp.minimum(a, b)
        return jnp.maximum(a, b)

    def __hash__(self):  # identity by name: safe for jit static args
        return hash((self.name, self.add_kind))

    def __eq__(self, other):
        return (
            isinstance(other, Semiring)
            and self.name == other.name
            and self.add_kind == other.add_kind
        )


def _times(a, b):
    return a * b


def _plus(a, b):
    return a + b


def _second(a, b):
    return b


def _first(a, b):
    return a


def _and(a, b):
    return jnp.logical_and(a != 0, b != 0).astype(jnp.result_type(a, b))


#: Arithmetic (+, *): the default ring (``Semirings.h:213``).
PLUS_TIMES = Semiring("plus_times", "sum", _times)
#: Tropical (min, +): shortest paths (``Semirings.h:236``).
MIN_PLUS = Semiring("min_plus", "min", _plus)
#: (max, +): critical paths / widest additive.
MAX_PLUS = Semiring("max_plus", "max", _plus)
#: (max, *): used by approximate-weight matching (``ApproxWeightPerfectMatching.h``).
MAX_TIMES = Semiring("max_times", "max", _times)
#: Boolean (or, and): structural products (``BoolCopy*SRing``, ``Semirings.h:51``).
OR_AND = Semiring("or_and", "max", _and)
#: (max, select2nd): BFS frontier expansion (``SelectMaxSRing``, ``Semirings.h:166``).
MAX_SECOND = Semiring("max_second", "max", _second)
#: (min, select2nd): FastSV grandparent propagation (``FastSV.h:347``).
MIN_SECOND = Semiring("min_second", "min", _second)
#: (max, select1st): masked selection.
MAX_FIRST = Semiring("max_first", "max", _first)

_REGISTRY = {
    sr.name: sr
    for sr in (
        PLUS_TIMES,
        MIN_PLUS,
        MAX_PLUS,
        MAX_TIMES,
        OR_AND,
        MAX_SECOND,
        MIN_SECOND,
        MAX_FIRST,
    )
}


def get_semiring(name: str) -> Semiring:
    """Look up a registered semiring by name."""
    return _REGISTRY[name]
