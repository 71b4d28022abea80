"""Array-based triangle mesh (host numpy, built once).

A mesh is a pair of numpy arrays ``coords[n_verts, 2]`` / ``cells[n_cells, 3]``
plus derived boundary connectivity. Everything the solver touches per step is
exported as device tensors by the FEM layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Local facet -> vertex numbering for triangles: facet i is opposite vertex i.
_TRI_FACETS = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)


@dataclass
class Mesh:
    """A 2D triangle mesh.

    Attributes
    ----------
    coords : [n_verts, 2] float64
    cells : [n_cells, 3] int32, vertex ids per cell
    boundary_facets : [n_bf, 2] int32, vertex ids of each boundary edge
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
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)
        if self.coords.ndim != 2 or self.coords.shape[1] != 2:
            raise ValueError("only 2D triangle meshes are supported")
        if self.boundary_facets is None:
            self._build_boundary()
        if self.facet_markers is None:
            self.facet_markers = np.zeros(len(self.boundary_facets),
                                          dtype=np.int32)

    @property
    def n_verts(self) -> int:
        return self.coords.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    def _build_boundary(self) -> None:
        # edges shared by exactly one triangle are boundary facets
        flat = self.cells[:, _TRI_FACETS].reshape(-1, 2)
        key = np.sort(flat, axis=1)
        _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                   return_counts=True)
        idx = np.where(counts[inv.reshape(-1)] == 1)[0]
        self.boundary_facets = flat[idx].astype(np.int32)
        self.boundary_cells = (idx // 3).astype(np.int32)

    def cell_h(self) -> np.ndarray:
        """Greatest vertex-to-vertex distance within each cell."""
        x = self.coords[self.cells]
        h = np.zeros(self.n_cells)
        for i in range(3):
            for j in range(i + 1, 3):
                h = np.maximum(h, np.linalg.norm(x[:, i] - x[:, j], axis=-1))
        return h

    def cell_extents(self) -> np.ndarray:
        """Per-cell bounding-box extents [n_cells, 2]."""
        x = self.coords[self.cells]
        return x.max(axis=1) - x.min(axis=1)

    def facet_normals(self) -> np.ndarray:
        """Outward unit normal per boundary facet [n_bf, 2]."""
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
