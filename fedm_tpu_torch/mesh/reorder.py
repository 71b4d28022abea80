"""Mesh graphs and node reordering (host numpy; the JAX package's
`mesh/reorder.py`).

- `vertex_adjacency_csr`: the vertex-vertex graph (self loops included),
  the input of the RCM ordering;
- `cell_adjacency_csr`: the dual graph (cells that share a facet), the
  input of the domain decomposition's partitioner (`parallel.dd`);
- `rcm_reorder`: the mesh renumbered by reverse Cuthill-McKee, for
  gather/scatter locality, with the permutation that maps nodal fields.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..native import rcm_order
from .mesh import Mesh


def _csr_of_pairs(e: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (rowptr, colidx), both int32, of row-sorted pairs e [m, 2]."""
    rowptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(rowptr, e[:, 0] + 1, 1)
    return np.cumsum(rowptr).astype(np.int32), e[:, 1].astype(np.int32)


def vertex_adjacency_csr(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric vertex-vertex adjacency (self loops included) in CSR."""
    cells = mesh.cells
    k = cells.shape[1]
    pairs = [np.stack([cells[:, i], cells[:, j]], axis=1)
             for i in range(k) for j in range(k)]
    return _csr_of_pairs(np.unique(np.concatenate(pairs), axis=0),
                         mesh.n_verts)


def cell_adjacency_csr(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Cell-cell adjacency (cells sharing a facet) in CSR: the dual graph
    that DOLFIN hands to SCOTCH to partition a mesh, and the input of
    `native.partition_graph` for the domain decomposition."""
    cells = mesh.cells
    if mesh.dim == 1:
        facets = cells[:, :, None]  # each vertex is a facet
    else:
        local = np.array([[1, 2], [0, 2], [0, 1]])
        facets = np.sort(cells[:, local], axis=2)  # [n_cells, 3, 2]
    nf = facets.shape[1]
    flat = facets.reshape(-1, facets.shape[2])
    owner = np.repeat(np.arange(mesh.n_cells), nf)
    _, inv = np.unique(flat, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    inv_s, owner_s = inv[order], owner[order]
    # an interior facet appears exactly twice: one adjacency pair each
    is_pair = inv_s[:-1] == inv_s[1:]
    a, b = owner_s[:-1][is_pair], owner_s[1:][is_pair]
    e = np.concatenate([np.stack([a, b], 1), np.stack([b, a], 1)])
    e = e[np.lexsort((e[:, 1], e[:, 0]))]
    return _csr_of_pairs(e, mesh.n_cells)


def rcm_reorder(mesh: Mesh) -> Tuple[Mesh, np.ndarray]:
    """(reordered mesh, perm) with perm[new] = old: a nodal field maps as
    f_new = f_old[perm]."""
    perm = rcm_order(*vertex_adjacency_csr(mesh))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return Mesh(mesh.coords[perm], inv[mesh.cells]), perm
