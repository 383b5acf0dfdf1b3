"""ProcGrid — the device-mesh counterpart of CommGrid / CommGrid3D.

The reference builds a √p×√p MPI grid with row/col/diagonal communicators and
rank algebra (``CommGrid.h:44-166``); the 3D variant adds a layer ("fiber")
axis (``CommGrid3D.h:9-121``).  Here the entire object collapses to a
``jax.sharding.Mesh`` with named axes — row/column "communicators" are just
axis names handed to collectives, and rank algebra is ``lax.axis_index``.
ProcGrid wraps the mesh with the few derived quantities the library needs and
the PartitionSpecs for canonical layouts.

Axis convention: 2D mesh axes ('r', 'c') — 'r' indexes block rows, 'c' block
columns.  3D adds a leading replication axis 'l' (layers), the
communication-avoiding axis of the reference's split-layer SpGEMM
(``ParFriends.h:2919``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["ProcGrid", "default_grid"]


@dataclasses.dataclass(frozen=True)
class ProcGrid:
    """A 2D (or 3D-layered) logical device grid over a jax Mesh.

    ``mesh`` axes are ('r', 'c') or ('l', 'r', 'c').  Hashable and static so it
    can ride in pytree aux data.
    """

    mesh: Mesh

    # -- construction -----------------------------------------------------
    @staticmethod
    def make(
        pr: Optional[int] = None,
        pc: Optional[int] = None,
        layers: int = 1,
        devices=None,
    ) -> "ProcGrid":
        """Build from a device list (defaults to all devices), factoring p into
        the squarest possible pr×pc (the reference requires perfect squares,
        ``CommGrid.cpp``; we relax to the squarest factorization)."""
        devices = list(jax.devices()) if devices is None else list(devices)
        p = len(devices) // layers
        if pr is None or pc is None:
            pr = int(np.sqrt(p))
            while p % pr:
                pr -= 1
            pc = p // pr
        assert pr * pc * layers == len(devices), (pr, pc, layers, len(devices))
        arr = np.asarray(devices).reshape(layers, pr, pc)
        if layers == 1:
            return ProcGrid(Mesh(arr[0], ("r", "c")))
        return ProcGrid(Mesh(arr, ("l", "r", "c")))

    # -- shape ------------------------------------------------------------
    @property
    def is3d(self) -> bool:
        return "l" in self.mesh.axis_names

    @property
    def layers(self) -> int:
        return self.mesh.shape["l"] if self.is3d else 1

    @property
    def pr(self) -> int:
        return self.mesh.shape["r"]

    @property
    def pc(self) -> int:
        return self.mesh.shape["c"]

    @property
    def nprocs(self) -> int:
        return self.layers * self.pr * self.pc

    # -- canonical shardings ---------------------------------------------
    def block_sharding(self) -> NamedSharding:
        """Sharding for (pr, pc, ...) block-stacked arrays."""
        return NamedSharding(self.mesh, P(*(("l",) if self.is3d else ()), "r", "c"))

    def vec_sharding(self) -> NamedSharding:
        """Canonical dense-vector sharding: length-N flat array spread over the
        whole grid row-major — the FullyDist layout (``FullyDist.h:109-140``)."""
        return NamedSharding(self.mesh, P(("r", "c")))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def grid2d(self) -> "ProcGrid":
        """The per-layer 2D grid of a 3D grid (reference: ``CommGrid3D::GetCommGridLayer``)."""
        if not self.is3d:
            return self
        sub = np.asarray(self.mesh.devices)[0]
        return ProcGrid(Mesh(sub, ("r", "c")))

    def __hash__(self):
        return hash((self.mesh.axis_names, self.mesh.devices.tobytes()))

    def __eq__(self, other):
        return (
            isinstance(other, ProcGrid)
            and self.mesh.axis_names == other.mesh.axis_names
            and self.mesh.devices.tolist() == other.mesh.devices.tolist()
        )


def default_grid(layers: int = 1) -> ProcGrid:
    """Grid over all visible devices (the reference's COMM_WORLD grid)."""
    return ProcGrid.make(layers=layers)
