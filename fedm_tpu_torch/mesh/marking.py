"""Geometric boundary marking with the reference's subdomain semantics
(the reference FEDM's `fedm/functions.py:48-124`, `Marking_boundaries`,
`LineSubDomain`, `CircleSubDomain`): facets whose vertices and midpoint
all satisfy boundaries[idx] get marker idx+1, later entries overriding
earlier ones. Entries (x[0] = r, x[1] = z):

  ['line', z1, z2, r1, r2]
  ['circle', center_z, center_r, radius]   the electrode side of the gap
  ['point', z]                             1D meshes (x[0] = z)
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .mesh import Mesh

_EPS = 3e-16  # DOLFIN_EPS


def _circle(points: np.ndarray, cz, cr, radius, gap_length,
            tol) -> np.ndarray:
    """On the circle (squared distance within `tol` of radius^2), on the
    gap's side of the centre: z <= 0 for a centre at or below 0, else
    z >= gap_length."""
    r, z = points[:, 0], points[:, 1]
    on = np.abs((r - cr) ** 2 + (z - cz) ** 2 - radius ** 2) <= tol
    return on & ((z <= 0) if cz <= 0 else (z >= gap_length))


def mark_boundaries(mesh: Mesh, boundaries: Sequence[List],
                    gap_length: float = 0.01, line_tol: float = None,
                    circle_tol: float = 1e-8) -> np.ndarray:
    """Mark boundary facets of `mesh`; returns the marker array (also stored
    on the mesh as `facet_markers`). `line_tol` (default: DOLFIN_EPS or
    1e-12 of the coordinates' extent, the larger) widens the line ranges
    and is the 'point' distance; `circle_tol` is the circle test's;
    `gap_length` picks the side of a 'circle'."""
    markers = np.zeros(len(mesh.boundary_facets), dtype=np.int32)
    if line_tol is None:
        extent = np.abs(mesh.coords).max() if mesh.n_verts else 1.0
        line_tol = max(_EPS, 1e-12 * extent)

    fpts = mesh.coords[mesh.boundary_facets]  # [n_bf, verts/facet, dim]
    test_pts = np.concatenate([fpts, fpts.mean(axis=1, keepdims=True)],
                              axis=1)
    n_bf, n_test = test_pts.shape[:2]
    flat = test_pts.reshape(-1, mesh.dim)

    for idx, boundary in enumerate(boundaries):
        kind = boundary[0]
        if kind == "line":
            z1, z2, r1, r2 = boundary[1:5]
            r, z = flat[:, 0], flat[:, 1]
            ok = ((r >= r1 - line_tol) & (r <= r2 + line_tol)
                  & (z >= z1 - line_tol) & (z <= z2 + line_tol))
        elif kind == "circle":
            cz, cr, radius = boundary[1:4]
            ok = _circle(flat, cz, cr, radius, gap_length, circle_tol)
        elif kind == "point":
            if mesh.dim != 1:
                raise ValueError("'point' boundaries are only valid on 1D "
                                 "meshes")
            ok = np.abs(flat[:, 0] - boundary[1]) <= line_tol
        else:
            raise ValueError(f"Invalid boundary type '{kind}'. Possible "
                             "values are 'circle', 'line', 'point'.")
        markers[ok.reshape(n_bf, n_test).all(axis=1)] = idx + 1

    mesh.facet_markers = markers
    return markers
