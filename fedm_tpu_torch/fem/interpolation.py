"""Inter-mesh nodal interpolation for the multigrid transfers (the JAX
package's `fem/interpolation.py`, 2D): P1 transfers between any nested
meshes, and the separable `StructuredTransfer` between nested
tensor-product grids.

Where the fine domain is covered by the coarse mesh (any nesting the
structured generators produce), each fine node's value is the P1
interpolation of the coarse nodal values of its containing coarse cell: a
static [n_fine, 3] index/weight table — a pure-gather prolongation, and its
transpose, a segment sum for the restriction, summed by K1's dense form
over the table's transpose (`restrict_table`), so in a fixed order on the
card too. Trailing dims of the transferred vectors are independent
right-hand sides. Point location bins the coarse cells' bounding boxes on
a uniform grid (host numpy, once).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.ell_scatter import ell_scatter
from .assembly import build_ell_index
from .space import FunctionSpace


def _locate_points(coarse_mesh, points: np.ndarray):
    """For each point: (cell index, barycentric weights [3])."""
    coords = coarse_mesh.coords
    cells = coarse_mesh.cells
    n_pts = len(points)

    # 2D: bin coarse cells by bounding box
    x_cells = coords[cells]  # [n_c, 3, 2]
    mins = x_cells.min(axis=1)
    maxs = x_cells.max(axis=1)
    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    nb = max(1, int(np.sqrt(len(cells) / 4)))
    span = np.maximum(hi - lo, 1e-300)

    def bin_of(p):
        return np.clip(((p - lo) / span * nb).astype(int), 0, nb - 1)

    bins = {}
    blo = bin_of(mins)
    bhi = bin_of(maxs)
    for c in range(len(cells)):
        for bx in range(blo[c, 0], bhi[c, 0] + 1):
            for by in range(blo[c, 1], bhi[c, 1] + 1):
                bins.setdefault((bx, by), []).append(c)

    v0 = x_cells[:, 0]
    T = np.stack([x_cells[:, 1] - v0, x_cells[:, 2] - v0], axis=2)
    det = T[:, 0, 0] * T[:, 1, 1] - T[:, 0, 1] * T[:, 1, 0]
    inv = np.stack(
        [np.stack([T[:, 1, 1], -T[:, 0, 1]], 1),
         np.stack([-T[:, 1, 0], T[:, 0, 0]], 1)], 1) / det[:, None, None]

    # vectorised: pad per-bin candidate lists to K and test every point
    # against its bin's candidates in one broadcast (the python-loop
    # version cost minutes on 5e4-node corridor meshes)
    K = max(len(v) for v in bins.values())
    bin_tab = np.full((nb * nb, K), -1, dtype=np.int64)
    for (bx, by), cs in bins.items():
        bin_tab[bx * nb + by, :len(cs)] = cs
    pb = bin_of(points)
    cand = bin_tab[pb[:, 0] * nb + pb[:, 1]]        # [n_pts, K]
    safe = np.where(cand < 0, 0, cand)
    r = points[:, None, :] - v0[safe]               # [n_pts, K, 2]
    lam12 = np.einsum("pkij,pkj->pki", inv[safe], r)
    lam0 = 1.0 - lam12.sum(axis=-1, keepdims=True)
    lams = np.concatenate([lam0, lam12], axis=-1)   # [n_pts, K, 3]
    d = -np.minimum(lams.min(axis=-1), 0.0)
    d[cand < 0] = np.inf
    best = d.argmin(axis=1)
    rows = np.arange(n_pts)
    best_d = d[rows, best]
    if not (best_d <= 1e-6).all():
        i = int(best_d.argmax())
        raise ValueError(
            f"point {points[i]} not inside any coarse cell "
            f"(residual {best_d[i]:.2e})")
    cell_out = cand[rows, best]
    w_out = np.clip(lams[rows, best], 0.0, 1.0)
    return cell_out, w_out


def p1_transfer(coarse: FunctionSpace, fine: FunctionSpace, dtype=None,
                *, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx [n_fine, 3] int64, weights [n_fine, 3]) on `device` such that
    prolongation is `(w * u_c[idx]).sum(-1)`."""
    dtype = torch.float64 if dtype is None else dtype
    cells, w = _locate_points(coarse.mesh, fine.dof_coords)
    idx = coarse.cell_dofs[cells]  # P1: cell dofs are vertex dofs
    return (torch.as_tensor(idx, dtype=torch.int64, device=device),
            torch.as_tensor(w, dtype=dtype, device=device))


def _wb(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w [n_fine, 3] against x [n_fine, 3, ...]."""
    return w.reshape(tuple(w.shape) + (1,) * (x.dim() - 2))


def prolong(idx: torch.Tensor, w: torch.Tensor,
            u_coarse: torch.Tensor) -> torch.Tensor:
    uc = u_coarse[idx]
    return (_wb(w, uc) * uc).sum(dim=1)


def restrict_table(idx: torch.Tensor, n_coarse: int) -> torch.Tensor:
    """The transpose of `p1_transfer`'s idx as an ELL table [n_coarse,
    max_val] int32 over the flat [n_fine * 3] weighted residuals, on idx's
    device (built on the host, once per level pair)."""
    return torch.as_tensor(build_ell_index(idx.cpu().numpy(), n_coarse),
                           device=idx.device)


def restrict(idx: torch.Tensor, w: torch.Tensor, r_fine: torch.Tensor,
             n_coarse: int, table: torch.Tensor = None) -> torch.Tensor:
    """Transpose of `prolong`: the segment sum of the weighted fine
    residuals (the JAX package's `segment_sum`), through K1's dense form
    over `table` (`restrict_table(idx, n_coarse)`, built here when not
    given), each coarse row summed in fine-row order."""
    if table is None:
        table = restrict_table(idx, n_coarse)
    vals = r_fine[:, None] * _wb(w, r_fine[:, None])
    return ell_scatter(vals.reshape((-1,) + tuple(r_fine.shape[1:]))
                       .contiguous(), table)


def prolong_axis(U: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Last axis [.., nc] -> [.., 2*nc-1] (linear, physical weights)."""
    odd = U[..., :-1] * (1.0 - w) + U[..., 1:] * w
    body = torch.stack([U[..., :-1], odd], dim=-1).flatten(-2)
    return torch.cat([body, U[..., -1:]], dim=-1)


def restrict_axis(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact transpose of `prolong_axis`: [.., 2*nc-1] -> [.., nc]."""
    odd = r[..., 1::2]
    return (r[..., ::2] + F.pad((1.0 - w) * odd, (0, 1))
            + F.pad(w * odd, (1, 0)))


class StructuredTransfer:
    """Separable prolongation and restriction between nested tensor-product
    vertex grids (fine [nif, njf] with nif = 2 * nic - 1) on flat vectors
    in the canonical `id = j * n_i + i` layout (the JAX package's
    `StructuredTransfer`). Prolongation is linear per axis with weights
    from the physical coordinates (graded meshes); restriction is its
    exact transpose. Pure slicing and padding: no gathers, no segment sums.
    """

    def __init__(self, xs_c, zs_c, xs_f, zs_f, dtype=None, *, device):
        dtype = torch.float64 if dtype is None else dtype
        xs_c, zs_c = np.asarray(xs_c), np.asarray(zs_c)
        xs_f, zs_f = np.asarray(xs_f), np.asarray(zs_f)
        if not (len(xs_f) == 2 * len(xs_c) - 1
                and len(zs_f) == 2 * len(zs_c) - 1
                and np.allclose(xs_f[::2], xs_c)
                and np.allclose(zs_f[::2], zs_c)):
            raise ValueError("the grids are not 2:1 nested")
        self.nic, self.njc = len(xs_c), len(zs_c)
        self.nif, self.njf = len(xs_f), len(zs_f)
        wx = (xs_f[1::2] - xs_c[:-1]) / (xs_c[1:] - xs_c[:-1])
        wz = (zs_f[1::2] - zs_c[:-1]) / (zs_c[1:] - zs_c[:-1])
        self._wx = torch.as_tensor(wx, dtype=dtype, device=device)
        self._wz = torch.as_tensor(wz, dtype=dtype, device=device)

    def prolong(self, e_c: torch.Tensor) -> torch.Tensor:
        """[n_c] or [n_c, b] (b right-hand sides) -> [n_f(, b)]."""
        E = self._grid(e_c, self.njc, self.nic)      # [(b,) j, i] layout
        E = prolong_axis(E, self._wx)               # along i
        E = prolong_axis(E.transpose(-1, -2), self._wz).transpose(-1, -2)
        return self._flat(E, e_c)

    def restrict(self, r_f: torch.Tensor) -> torch.Tensor:
        R = self._grid(r_f, self.njf, self.nif)
        R = restrict_axis(R, self._wx)
        R = restrict_axis(R.transpose(-1, -2), self._wz).transpose(-1, -2)
        return self._flat(R, r_f)

    @staticmethod
    def _grid(x: torch.Tensor, n_j: int, n_i: int) -> torch.Tensor:
        if x.dim() == 1:
            return x.reshape(n_j, n_i)
        return x.reshape(n_j, n_i, -1).permute(2, 0, 1)

    @staticmethod
    def _flat(X: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.dim() == 1:
            return X.reshape(-1)
        return X.permute(1, 2, 0).reshape((-1,) + tuple(like.shape[1:]))
