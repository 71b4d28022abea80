"""Lagrange function spaces: global dof enumeration (host numpy, once).

A scalar space is `n_dofs` values; a coupled system is a dense
`[n_dofs, n_eq]` tensor. P1 dofs are the mesh vertices; P2 adds one dof per
interval (its midpoint) or per unique triangle edge, numbered after the
vertices in the JAX package's order.
"""

from __future__ import annotations

import numpy as np

from ..mesh import Mesh
from .elements import n_local_dofs


class FunctionSpace:
    """Scalar Lagrange space of degree 1 or 2 on a simplicial mesh.

    Attributes
    ----------
    cell_dofs : [n_cells, n_local] int32
    n_dofs : int
    dof_coords : [n_dofs, dim]
    """

    def __init__(self, mesh: Mesh, degree: int = 1):
        if degree not in (1, 2):
            raise ValueError("degree must be 1 or 2")
        self.mesh = mesh
        self.degree = degree
        self.cell_type = "interval" if mesh.dim == 1 else "triangle"
        self.n_local = n_local_dofs(self.cell_type, degree)
        self._edge_of_facet = None
        if degree == 1:
            self.cell_dofs = mesh.cells.copy()
            self.n_dofs = mesh.n_verts
            self.dof_coords = mesh.coords.copy()
        else:
            self._build_p2()

    def _build_p2(self):
        mesh = self.mesh
        if mesh.dim == 1:
            # one midpoint dof per cell: [v0, v1, m]
            mids = mesh.n_verts + np.arange(mesh.n_cells, dtype=np.int32)
            self.cell_dofs = np.concatenate([mesh.cells, mids[:, None]],
                                            axis=1)
            self.dof_coords = np.concatenate(
                [mesh.coords, mesh.coords[mesh.cells].mean(axis=1)])
            self.n_dofs = mesh.n_verts + mesh.n_cells
            return

        # 2D: unique edges; edge dof i is opposite vertex i
        local_edges = np.array([[1, 2], [0, 2], [0, 1]])
        edges = mesh.cells[:, local_edges].reshape(-1, 2)
        uniq, inv = np.unique(np.sort(edges, axis=1), axis=0,
                              return_inverse=True)
        edge_dofs = (mesh.n_verts
                     + inv.reshape(mesh.n_cells, 3)).astype(np.int32)
        self.cell_dofs = np.concatenate([mesh.cells, edge_dofs], axis=1)
        self.dof_coords = np.concatenate([mesh.coords,
                                          mesh.coords[uniq].mean(axis=1)])
        self.n_dofs = mesh.n_verts + len(uniq)

        # boundary facet -> edge dof (Dirichlet values on P2), by a search
        # over int64 keys: int32 keys overflow past ~46k vertices
        bkey = np.sort(mesh.boundary_facets, axis=1)
        order = np.lexsort((uniq[:, 1], uniq[:, 0]))
        uniq_sorted = uniq[order]
        stride = np.int64(mesh.n_verts + 1)
        pos = np.searchsorted(
            uniq_sorted[:, 0].astype(np.int64) * stride
            + uniq_sorted[:, 1].astype(np.int64),
            bkey[:, 0].astype(np.int64) * stride
            + bkey[:, 1].astype(np.int64))
        self._edge_of_facet = (mesh.n_verts + order[pos]).astype(np.int32)

    def boundary_dofs(self, facet_mask: np.ndarray = None) -> np.ndarray:
        """Dof ids on the boundary facets selected by `facet_mask` [n_bf]
        bool (default every boundary facet), edge dofs included on P2."""
        mesh = self.mesh
        if facet_mask is None:
            facet_mask = np.ones(len(mesh.boundary_facets), dtype=bool)
        dofs = [mesh.boundary_facets[facet_mask].ravel()]
        if self._edge_of_facet is not None:
            dofs.append(self._edge_of_facet[facet_mask])
        return np.unique(np.concatenate(dofs)).astype(np.int32)

    def dofs_where(self, predicate) -> np.ndarray:
        """Dof ids whose coordinates satisfy `predicate(coords) -> bool`."""
        return np.where(predicate(self.dof_coords))[0].astype(np.int32)
