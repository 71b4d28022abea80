"""Array-based simplicial mesh (host numpy, built once).

A mesh is a pair of numpy arrays ``coords[n_verts, dim]`` /
``cells[n_cells, dim+1]`` plus derived boundary connectivity: intervals in
1D, triangles in 2D (the reference's `IntervalMesh` and `RectangleMesh`).
Everything the solver touches per step is exported as device tensors by the
FEM layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from textwrap import dedent

import numpy as np

# Local facet -> vertex numbering for triangles: facet i is opposite vertex i.
_TRI_FACETS = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)


@dataclass
class Mesh:
    """A simplicial mesh (intervals in 1D, triangles in 2D).

    Attributes
    ----------
    coords : [n_verts, dim] float64
    cells : [n_cells, dim+1] int32, vertex ids per cell
    boundary_facets : [n_bf, dim] int32, vertex ids of each boundary facet
        (a single vertex in 1D, an edge in 2D)
    boundary_cells : [n_bf] int32, the unique cell adjacent to each facet
    facet_markers : [n_bf] int32, marker per boundary facet (0 = unmarked;
        set by `mark_boundaries`)
    """

    coords: np.ndarray
    cells: np.ndarray
    boundary_facets: np.ndarray = field(default=None, repr=False)
    boundary_cells: np.ndarray = field(default=None, repr=False)
    facet_markers: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        if self.coords.ndim == 1:
            self.coords = self.coords[:, None]
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)
        if self.boundary_facets is None:
            self._build_boundary()
        if self.facet_markers is None:
            self.facet_markers = np.zeros(len(self.boundary_facets),
                                          dtype=np.int32)

    @property
    def dim(self) -> int:
        return self.coords.shape[1]

    @property
    def n_verts(self) -> int:
        return self.coords.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    def _build_boundary(self) -> None:
        if self.dim == 1:
            # facets are vertices; a boundary vertex lies in exactly one cell
            counts = np.bincount(self.cells.ravel(), minlength=self.n_verts)
            bverts = np.where(counts == 1)[0].astype(np.int32)
            cell_of = np.full(self.n_verts, -1, dtype=np.int32)
            for local in range(2):
                cell_of[self.cells[:, local]] = np.arange(self.n_cells,
                                                          dtype=np.int32)
            self.boundary_facets = bverts[:, None]
            self.boundary_cells = cell_of[bverts]
        elif self.dim == 2:
            # edges shared by exactly one triangle are boundary facets
            flat = self.cells[:, _TRI_FACETS].reshape(-1, 2)
            key = np.sort(flat, axis=1)
            _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                       return_counts=True)
            idx = np.where(counts[inv.reshape(-1)] == 1)[0]
            self.boundary_facets = flat[idx].astype(np.int32)
            self.boundary_cells = (idx // 3).astype(np.int32)
        else:
            raise ValueError(f"Unsupported mesh dimension {self.dim}")

    def cell_h(self) -> np.ndarray:
        """Greatest vertex-to-vertex distance within each cell (dolfin's
        hmax convention)."""
        x = self.coords[self.cells]
        nv = x.shape[1]
        h = np.zeros(self.n_cells)
        for i in range(nv):
            for j in range(i + 1, nv):
                h = np.maximum(h, np.linalg.norm(x[:, i] - x[:, j], axis=-1))
        return h

    def cell_extents(self) -> np.ndarray:
        """Per-cell bounding-box extents [n_cells, dim]."""
        x = self.coords[self.cells]
        return x.max(axis=1) - x.min(axis=1)

    def hmax(self) -> float:
        return float(self.cell_h().max())

    def hmin(self) -> float:
        return float(self.cell_h().min())

    def facet_midpoints(self) -> np.ndarray:
        return self.coords[self.boundary_facets].mean(axis=1)

    def facet_normals(self) -> np.ndarray:
        """Outward unit normal per boundary facet [n_bf, dim]: +-1 in 1D."""
        if self.dim == 1:
            xm = self.coords[self.boundary_facets[:, 0], 0]
            centroid = self.coords[self.cells[self.boundary_cells],
                                   0].mean(axis=1)
            return np.sign(xm - centroid)[:, None]
        a = self.coords[self.boundary_facets[:, 0]]
        b = self.coords[self.boundary_facets[:, 1]]
        t = b - a
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        # orient away from the adjacent cell's centroid
        centroid = self.coords[self.cells[self.boundary_cells]].mean(axis=1)
        flip = np.sum(n * (centroid - 0.5 * (a + b)), axis=1) > 0
        n[flip] *= -1.0
        return n


def mesh_info(mesh: Mesh) -> str:
    """Mesh statistics string, with the fields of the reference's
    `mesh_info`."""
    return dedent(
        f"""\
        Number of elements is: {mesh.n_cells}
        Maximum element edge length is: {mesh.hmax():.5g}
        Minimum element edge length is: {mesh.hmin():.5g}
        """
    )
