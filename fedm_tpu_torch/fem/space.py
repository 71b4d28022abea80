"""P1 Lagrange function space: one dof per mesh vertex (host, once)."""

from __future__ import annotations

import numpy as np

from ..mesh import Mesh


class FunctionSpace:
    """Scalar P1 space on a triangle mesh.

    Attributes
    ----------
    cell_dofs : [n_cells, 3] int32
    n_dofs : int
    dof_coords : [n_dofs, 2]
    """

    n_local = 3

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.cell_dofs = mesh.cells.copy()
        self.n_dofs = mesh.n_verts
        self.dof_coords = mesh.coords.copy()

    def dofs_where(self, predicate) -> np.ndarray:
        """Dof ids whose coordinates satisfy `predicate(coords) -> bool`."""
        return np.where(predicate(self.dof_coords))[0].astype(np.int32)
