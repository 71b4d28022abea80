"""Structured rectangle mesh generator (the 'right' diagonal split)."""

from __future__ import annotations

import numpy as np

from .mesh import Mesh


def rectangle_mesh(p0: tuple, p1: tuple, nx: int, ny: int) -> Mesh:
    """Triangle mesh of the rectangle [p0, p1] with nx-by-ny quads, each
    split lower-left to upper-right. Vertex id = iy*(nx+1) + ix; the lower
    triangles (ll, lr, ur) of all quads come first, then the upper ones
    (ll, ur, ul), each block y-major — the layout structured assembly
    relies on."""
    xs = np.linspace(float(p0[0]), float(p1[0]), nx + 1)
    ys = np.linspace(float(p0[1]), float(p1[1]), ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    IX, IY = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    ll = (IY * (nx + 1) + IX).ravel()
    lr = ll + 1
    ul = ll + (nx + 1)
    ur = ul + 1
    tris = np.concatenate([np.stack([ll, lr, ur], axis=1),
                           np.stack([ll, ur, ul], axis=1)])
    return Mesh(coords, tris.astype(np.int32))
