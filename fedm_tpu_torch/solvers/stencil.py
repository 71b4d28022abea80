"""Tensor-product node-grid detection."""

from __future__ import annotations

import numpy as np


def canonical_node_grid(space):
    """[n_i, n_j] node-id grid of a P1 space on a tensor-product mesh in the
    canonical `id = j * n_i + i` layout, or None if the space is not of that
    form."""
    c = np.asarray(space.dof_coords)
    xs, zs = np.unique(c[:, 0]), np.unique(c[:, 1])
    if len(xs) * len(zs) != space.n_dofs:
        return None
    ix = np.searchsorted(xs, c[:, 0])
    iz = np.searchsorted(zs, c[:, 1])
    if not np.array_equal(iz * len(xs) + ix, np.arange(space.n_dofs)):
        return None
    I, J = np.meshgrid(np.arange(len(xs)), np.arange(len(zs)),
                       indexing="ij")
    return J * len(xs) + I
