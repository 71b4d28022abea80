"""Geometric boundary marking with the reference's line-subdomain semantics
(the reference FEDM's `fedm/functions.py:48-124`): facets whose vertices and
midpoint all satisfy boundaries[idx] get marker idx+1, later entries
overriding earlier ones. Entries are ``['line', z1, z2, r1, r2]`` with
x[0] = r and x[1] = z."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .mesh import Mesh

_EPS = 3e-16  # DOLFIN_EPS


def mark_boundaries(mesh: Mesh, boundaries: Sequence[List]) -> np.ndarray:
    """Mark boundary facets of `mesh`; returns the marker array (also stored
    on the mesh as `facet_markers`)."""
    markers = np.zeros(len(mesh.boundary_facets), dtype=np.int32)
    extent = np.abs(mesh.coords).max() if mesh.n_verts else 1.0
    tol = max(_EPS, 1e-12 * extent)

    fpts = mesh.coords[mesh.boundary_facets]  # [n_bf, 2, 2]
    test_pts = np.concatenate([fpts, fpts.mean(axis=1, keepdims=True)],
                              axis=1)
    n_bf, n_test = test_pts.shape[:2]
    r, z = test_pts.reshape(-1, 2).T

    for idx, boundary in enumerate(boundaries):
        if boundary[0] != "line":
            raise ValueError(f"boundary type {boundary[0]!r} is not supported"
                             " (only 'line')")
        z1, z2, r1, r2 = boundary[1:5]
        ok = ((r >= r1 - tol) & (r <= r2 + tol)
              & (z >= z1 - tol) & (z <= z2 + tol))
        markers[ok.reshape(n_bf, n_test).all(axis=1)] = idx + 1

    mesh.facet_markers = markers
    return markers
