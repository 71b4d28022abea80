"""Structured mesh generators of the JAX package's `mesh/generators.py`:
the uniform interval and the rectangle with its three diagonal patterns
(the same vertex and cell order: every ELL table and sum order follows
from it)."""

from __future__ import annotations

import numpy as np

from .mesh import Mesh


def interval_mesh(n: int, a: float, b: float) -> Mesh:
    """Uniform 1D mesh with `n` cells on [a, b]."""
    coords = np.linspace(a, b, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh(coords, cells)


def rectangle_mesh(p0: tuple, p1: tuple, nx: int, ny: int,
                   diagonal: str = "right") -> Mesh:
    """Triangle mesh of the rectangle [p0, p1] with nx-by-ny quads.
    Grid vertex id = iy*(nx+1) + ix.

    diagonal:
      'right'   - each quad split lower-left to upper-right: the lower
                  triangles (ll, lr, ur) of all quads first, then the upper
                  ones (ll, ur, ul), each block y-major — the layout
                  structured assembly relies on;
      'left'    - split lower-right to upper-left: (ll, lr, ul), then
                  (lr, ur, ul);
      'crossed' - a centre vertex per quad (ids after the grid's, in quad
                  order) and 4 triangles per quad: (ll, lr, c), (lr, ur, c),
                  (ur, ul, c), (ul, ll, c), each block over all quads."""
    xs = np.linspace(float(p0[0]), float(p1[0]), nx + 1)
    ys = np.linspace(float(p0[1]), float(p1[1]), ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    IX, IY = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    ll = (IY * (nx + 1) + IX).ravel()
    lr = ll + 1
    ul = ll + (nx + 1)
    ur = ul + 1
    if diagonal == "right":
        tris = np.concatenate([np.stack([ll, lr, ur], axis=1),
                               np.stack([ll, ur, ul], axis=1)])
    elif diagonal == "left":
        tris = np.concatenate([np.stack([ll, lr, ul], axis=1),
                               np.stack([lr, ur, ul], axis=1)])
    elif diagonal == "crossed":
        centres = 0.25 * (coords[ll] + coords[lr] + coords[ul] + coords[ur])
        cc = coords.shape[0] + np.arange(nx * ny)
        coords = np.concatenate([coords, centres])
        tris = np.concatenate([np.stack([ll, lr, cc], axis=1),
                               np.stack([lr, ur, cc], axis=1),
                               np.stack([ur, ul, cc], axis=1),
                               np.stack([ul, ll, cc], axis=1)])
    else:
        raise ValueError(f"diagonal '{diagonal}' not recognised; options: "
                         "'right', 'left', 'crossed'")
    return Mesh(coords, tris.astype(np.int32))
