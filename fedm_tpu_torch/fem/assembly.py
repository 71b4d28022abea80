"""Batched element assembly: gather -> per-element tensor ops -> scatter.

Element kernels are functions of *gathered* element values
``u_e [n_cells, n_local, ...]``; `value`/`grad`/`mass`/`stiffness` evaluate
them at quadrature points and contract back against the test functions.
Two scatter layouts serve the two batch kinds of the streamer:

- structured: on the canonical `rectangle_mesh` ordering, gather is six
  contiguous slices of the [ny+1, nx+1] vertex grid and scatter six
  slice-adds — no index chasing at all;
- ELL: per destination dof, the static list of flat contribution rows,
  summed by the ELL gather-sum kernel (`ops.ell_scatter`). `scatter_add`,
  the residual's accumulation, uses the table compacted to the dofs that
  receive a contribution and adds into the caller's tensor in one launch.

Axisymmetric weighting (`2*pi*r`) is folded into the per-quadrature-point
`scale` at setup. Host geometry is computed in float64 numpy exactly as the
JAX package computes it, then stored in the batch's compute dtype.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..constants import pi
from ..ops.ell_scatter import ell_scatter, ell_scatter_add_
from .elements import cell_quadrature, facet_quadrature, tabulate
from .space import FunctionSpace


def _scale_like(scale: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Broadcast scale [c, q] against s [c, q, ...]."""
    return scale.reshape(tuple(scale.shape) + (1,) * (s.dim() - 2))


def _inverse_jacobians(x_cells: np.ndarray):
    """Affine maps of simplices x_cells [n, dim+1, dim]: (detJ [n],
    invJ [n, dim, dim]), intervals and triangles."""
    x0 = x_cells[:, 0]
    dim = x_cells.shape[2]
    J = np.stack([x_cells[:, i + 1] - x0 for i in range(dim)], axis=2)
    if dim == 1:
        detJ = J[:, 0, 0]
        return detJ, (1.0 / detJ)[:, None, None]
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    invJ = np.stack([np.stack([J[:, 1, 1], -J[:, 0, 1]], axis=1),
                     np.stack([-J[:, 1, 0], J[:, 0, 0]], axis=1)],
                    axis=1) / detJ[:, None, None]
    return detJ, invJ


def _physical_tables(space: FunctionSpace, ref_pts: np.ndarray,
                     x_cells: np.ndarray):
    """Shape values, physical gradients and quadrature points of the cells
    x_cells [n, dim+1, dim] at reference points ref_pts [n_q, dim] (one
    set for every cell) or [n, n_q, dim] (per cell): (N [(n,) n_q,
    n_local], grads [n, g, n_local, dim], x_q [n, n_q, dim], detJ [n]),
    with g = 1 for affine P1 (the gradients do not vary over the cell)
    and g = n_q otherwise."""
    per_cell = ref_pts.ndim == 3
    flat = ref_pts.reshape(-1, ref_pts.shape[-1])
    N, dN = tabulate(space.cell_type, space.degree, flat)
    Nv, _ = tabulate(space.cell_type, 1, flat)
    detJ, invJ = _inverse_jacobians(x_cells)
    if per_cell:
        n, n_q = ref_pts.shape[:2]
        N = N.reshape(n, n_q, -1)
        dN = dN.reshape(n, n_q, N.shape[-1], -1)
        grads = np.einsum("cqak,ckd->cqad", dN, invJ)
        x_q = np.einsum("cqa,cad->cqd", Nv.reshape(n, n_q, -1), x_cells)
    else:
        grads = np.einsum("qak,ckd->cqad", dN, invJ)
        x_q = np.einsum("qa,cad->cqd", Nv, x_cells)
    if space.degree == 1:
        grads = grads[:, :1]
    return N, grads, x_q, detJ


def build_ell_index(dofs: np.ndarray, n_dofs: int) -> np.ndarray:
    """ELL table [n_dofs, max_val] of flat contribution rows per destination
    dof, padded with the sentinel `dofs.size` (one past the last row)."""
    flat = np.asarray(dofs).reshape(-1)
    L = flat.size
    max_val = int(np.bincount(flat, minlength=n_dofs).max())
    idx = np.full((n_dofs, max_val), L, dtype=np.int64)
    order = np.argsort(flat, kind="stable")
    sorted_d = flat[order]
    seg_start = np.searchsorted(sorted_d, np.arange(n_dofs))
    idx[sorted_d, np.arange(L) - seg_start[sorted_d]] = order
    return idx.astype(np.int32)


def build_ell_index_compact(dofs: np.ndarray, n_dofs: int):
    """The ELL table restricted to its live rows: (rows [n_live], idx
    [n_live, max_val]), both int32. `rows` lists, ascending, the dofs that
    receive at least one contribution; row r of `idx` is row `rows[r]` of
    `build_ell_index(dofs, n_dofs)`, same order and sentinel."""
    flat = np.asarray(dofs).reshape(-1)
    rows = np.unique(flat)
    return (rows.astype(np.int32),
            build_ell_index(flat, n_dofs)[rows])


def _live_table(dofs: np.ndarray, n_dofs: int, dead=None) -> np.ndarray:
    """`build_ell_index(dofs, n_dofs)` with the elements marked `dead`
    given no slot: their entries point at an extra row that is dropped,
    and the table is cut to the widest remaining row."""
    if dead is None or not np.any(dead):
        return build_ell_index(dofs, n_dofs)
    d = np.where(np.asarray(dead)[:, None], n_dofs, dofs)
    table = build_ell_index(d, n_dofs + 1)[:n_dofs]
    width = max(int((table < d.size).sum(axis=1).max()), 1)
    return np.ascontiguousarray(table[:, :width])


class _Batch:
    """Shared scatter / dtype handling of cell and facet batches."""

    _FLOAT_FIELDS: tuple = ()
    _SHARD_FIELDS: tuple = ()
    gather_idx = None  # ELL table [n_dofs, max_val] int32 on the device
    scatter_rows = None  # live dofs [n_live] int32 (None: every dof)
    scatter_idx = None  # ELL table of the live dofs [n_live, max_val]
    _structured = None  # (nx, ny) when slice/pad assembly is active

    def astype(self, dtype) -> "_Batch":
        """A view of this batch with its float tables cast to `dtype`
        (cached). Casting the stored tables — not recomputing them — keeps
        a float64 evaluation on exactly the float32 geometry, as the JAX
        package's promotion of mixed f32/f64 einsums does."""
        if dtype == self.dtype:
            return self
        views = self.__dict__.setdefault("_views", {})
        if dtype not in views:
            view = copy.copy(self)
            view.__dict__["_views"] = {}
            for f in self._FLOAT_FIELDS:
                setattr(view, f, getattr(self, f).to(dtype))
            view.dtype = dtype
            views[dtype] = view
        return views[dtype]

    def set_geometry(self, new: "_Batch") -> None:
        """Take the coordinate-derived tables of `new`, a batch of the same
        kind built on the same topology with moved nodes. Shapes, types and
        the scatter tables stay; the compact scatter table is a function of
        the topology alone, and is checked to come out the same."""
        if not np.array_equal(new.dofs_np, self.dofs_np):
            raise ValueError("geometry update changed the batch's topology")
        for f in self._GEOM_FIELDS:
            old, arr = getattr(self, f), getattr(new, f)
            if (arr.shape, arr.dtype, arr.device) != (old.shape, old.dtype,
                                                      old.device):
                raise ValueError(f"geometry update changed {f}: "
                                 f"{tuple(old.shape)} {old.dtype} -> "
                                 f"{tuple(arr.shape)} {arr.dtype}")
        if self.scatter_idx is not None:
            rows, idx = build_ell_index_compact(new.dofs_np, new.n_dofs)
            held_rows = (np.arange(self.n_dofs) if self.scatter_rows is None
                         else self.scatter_rows.cpu().numpy())
            if not (np.array_equal(rows, held_rows) and np.array_equal(
                    idx, self.scatter_idx.cpu().numpy())):
                raise AssertionError("the compact scatter table changed in "
                                     "a geometry update")
        for f in self._GEOM_FIELDS:
            setattr(self, f, getattr(new, f))
        self.space = new.space
        self.__dict__.pop("_views", None)  # casts of the old tables

    def local_view(self, arrays: dict, n_dofs: int,
                   dead=None) -> "_Batch":
        """A batch of the same kind and quadrature over other elements:
        `arrays` maps each name of `_SHARD_FIELDS` to a numpy array whose
        leading axis is the new element axis, and the dofs index a nodal
        array of `n_dofs` rows (the counterpart of the JAX package's
        `local_view`). The domain decomposition builds its per-part
        batches so, all parts stacked along the element axis, and a batched
        sweep its B members. The view scatters through ELL tables of its
        dofs as `build_scatter_meta` builds them, never on the structured
        slice/pad path. `dead` [n_elems] bool marks padding elements whose
        contributions nobody reads: they get no slot in either table."""
        view = copy.copy(self)
        view.__dict__.pop("_views", None)  # casts of the source's tables
        view._structured = None
        for f in self._SHARD_FIELDS:
            a = np.ascontiguousarray(arrays[f])
            if f == "dofs":
                view.dofs_np = a.astype(self.dofs_np.dtype)
                view.dofs = torch.as_tensor(view.dofs_np, device=self.device)
            else:
                setattr(view, f, torch.as_tensor(
                    a, dtype=getattr(self, f).dtype, device=self.device))
        view.n_dofs = int(n_dofs)
        if "n_facets" in view.__dict__:
            view.n_facets = view.dofs_np.shape[0]
        view.build_scatter_meta(dead)
        return view

    def build_scatter_meta(self, dead=None) -> None:
        """Switch `scatter` and `scatter_add` to the ELL gather-sum layout:
        the table over every dof and the one compacted to the live dofs
        (the same tensor where every dof is live); elements marked `dead`
        get no slot (`local_view`)."""
        table = _live_table(self.dofs_np, self.n_dofs, dead)
        self.gather_idx = torch.as_tensor(table, device=self.device)
        live = np.flatnonzero((table < self.dofs_np.size).any(axis=1))
        if live.size == self.n_dofs:
            self.scatter_rows, self.scatter_idx = None, self.gather_idx
        else:
            self.scatter_rows = torch.as_tensor(live.astype(np.int32),
                                                device=self.device)
            self.scatter_idx = torch.as_tensor(table[live],
                                               device=self.device)

    def scatter(self, contrib: torch.Tensor) -> torch.Tensor:
        """[n_elems, n_local, ...] -> global [n_dofs, ...]."""
        trailing = tuple(contrib.shape[2:])
        if self._structured is not None:
            nx, ny = self._structured
            C = contrib.reshape((2, ny, nx, 3) + trailing)
            out = torch.zeros((ny + 1, nx + 1) + trailing,
                              dtype=contrib.dtype, device=contrib.device)
            for b, offs in enumerate(self._offsets):
                for l, (dy, dx) in enumerate(offs):
                    out[dy:dy + ny, dx:dx + nx] += C[b, :, :, l]
            return out.reshape((self.n_dofs,) + trailing)
        if self.gather_idx is None:
            self.build_scatter_meta()
        flat = contrib.reshape((-1,) + trailing).contiguous()
        return ell_scatter(flat, self.gather_idx)

    def scatter_add(self, out: torch.Tensor,
                    contrib: torch.Tensor) -> torch.Tensor:
        """Add scatter(contrib) into `out` in place, summed in the order of
        out + scatter(contrib), and return `out`. On the ELL layout this is
        one launch over the live dofs."""
        if self._structured is not None:
            out += self.scatter(contrib)
            return out
        if self.gather_idx is None:
            self.build_scatter_meta()
        flat = contrib.reshape((-1,) + tuple(contrib.shape[2:])).contiguous()
        return ell_scatter_add_(out, flat, self.scatter_idx,
                                self.scatter_rows)

    def integrate(self, s: torch.Tensor) -> torch.Tensor:
        """Integral of s [n_elems, n_q, ...] over the batch."""
        return torch.sum(s * _scale_like(self.scale, s), dim=(0, 1))


class CellBatch(_Batch):
    """Cell-integral data for one space (P1/P2, intervals or triangles)
    and quadrature.

    Device tensors:
      N      [n_q, n_local]              reference shape values
      grads  [n_cells, g, n_local, dim]  physical shape gradients (g = 1
                                         for affine P1, n_q otherwise)
      scale  [n_cells, n_q]              w_q * |detJ| * (2*pi*r | 1)
      x_q    [n_cells, n_q, dim]         physical quadrature points
      h      [n_cells]                   cell size (greatest vertex
                                         distance)
      h_dir  [n_cells, dim]              bounding-box extents, for the
                                         directional cell size of upwinding
      dofs   [n_cells, n_local]
    """

    _FLOAT_FIELDS = ("N", "grads", "scale", "x_q", "h", "h_dir")
    _GEOM_FIELDS = ("grads", "scale", "x_q", "h", "h_dir")
    # the per-cell tables (leading axis: the cell), what `local_view` takes
    _SHARD_FIELDS = ("grads", "scale", "x_q", "dofs", "h", "h_dir")

    def __init__(self, space: FunctionSpace, quad_degree: int = 4,
                 axisymmetric: bool = False, dtype=None, *, device):
        dtype = torch.float64 if dtype is None else dtype
        mesh = space.mesh
        self.space = space
        self.axisymmetric = axisymmetric
        self.dtype = dtype
        self.device = torch.device(device)
        pts, wts = cell_quadrature(space.cell_type, quad_degree)
        self.n_q = len(wts)
        self.n_local = space.n_local
        self.n_dofs = space.n_dofs
        self.dim = mesh.dim

        N, grads, x_q, detJ = _physical_tables(space, pts,
                                               mesh.coords[mesh.cells])
        scale = wts[None, :] * np.abs(detJ)[:, None]
        if axisymmetric:
            scale = scale * (2.0 * pi * x_q[:, :, 0])

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self.N = put(N)
        self.grads = put(grads)
        self.scale = put(scale)
        self.x_q = put(x_q)
        self.h = put(mesh.cell_h())
        self.h_dir = put(mesh.cell_extents())
        self.dofs_np = space.cell_dofs
        self.dofs = torch.as_tensor(space.cell_dofs, device=self.device)

    # -- structured (tensor-product grid) assembly ---------------------------

    def try_structured(self) -> bool:
        """Engage slice/pad gather/scatter if the cells follow the canonical
        `rectangle_mesh` layout; returns whether it engaged."""
        d = self.dofs_np
        if self.space.degree != 1 or d.shape[1] != 3:
            return False  # P1 triangles only, as in the JAX package
        nx = int(d[0, 2]) - 2  # cell 0 = (ll=0, lr=1, ur=nx+2)
        n_cells = d.shape[0]
        if nx <= 0 or n_cells % (2 * nx):
            return False
        ny = n_cells // (2 * nx)
        if (nx + 1) * (ny + 1) != self.n_dofs:
            return False
        ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")

        def vid(dx, dy):
            return ((iy + dy) * (nx + 1) + ix + dx).ravel()

        expect = np.concatenate([
            np.stack([vid(0, 0), vid(1, 0), vid(1, 1)], axis=1),
            np.stack([vid(0, 0), vid(1, 1), vid(0, 1)], axis=1)])
        if not np.array_equal(d, expect):
            return False
        self._structured = (nx, ny)
        # (dy, dx) of each (block, local) vertex
        self._offsets = (((0, 0), (0, 1), (1, 1)), ((0, 0), (1, 1), (1, 0)))
        return True

    # -- evaluation on gathered element values -------------------------------

    def gather(self, u: torch.Tensor) -> torch.Tensor:
        """Nodal [n_dofs, ...] -> element values [n_cells, n_local, ...]."""
        if self._structured is None:
            return u[self.dofs]
        nx, ny = self._structured
        trailing = tuple(u.shape[1:])
        U = u.reshape((ny + 1, nx + 1) + trailing)
        blocks = [torch.stack([U[dy:dy + ny, dx:dx + nx].reshape(
            (nx * ny,) + trailing) for dy, dx in offs], dim=1)
            for offs in self._offsets]
        return torch.cat(blocks, dim=0)

    def value(self, u_e: torch.Tensor) -> torch.Tensor:
        """[n_cells, n_local, ...] -> values at quadrature points
        [n_cells, n_q, ...]."""
        return torch.einsum("qa,ca...->cq...", self.N, u_e)

    def grad(self, u_e: torch.Tensor) -> torch.Tensor:
        """[n_cells, n_local, ...] -> gradients [n_cells, n_q, dim, ...]."""
        g = torch.einsum("cqad,ca...->cqd...", self.grads, u_e)
        return g.expand((g.shape[0], self.n_q) + tuple(g.shape[2:]))

    def mass(self, s: torch.Tensor) -> torch.Tensor:
        """Integral of s * phi_a: s [n_cells, n_q, ...] ->
        [n_cells, n_local, ...]."""
        return torch.einsum("qa,cq...->ca...", self.N,
                            s * _scale_like(self.scale, s))

    def stiffness(self, G: torch.Tensor) -> torch.Tensor:
        """Integral of G . grad phi_a: G [n_cells, n_q, dim, ...] ->
        [n_cells, n_local, ...]."""
        Gs = G * _scale_like(self.scale, G)
        if self.grads.shape[1] == 1:
            return torch.einsum("cad,cd...->ca...", self.grads[:, 0],
                                Gs.sum(dim=1))
        return torch.einsum("cqad,cqd...->ca...", self.grads, Gs)


class FacetBatch(_Batch):
    """Boundary-facet integral data for the facets carrying `markers`
    (every boundary facet with None), evaluated through the adjacent
    cell's basis restricted to the facet (so normal gradients come from
    the same gathered values). A facet is a point in 1D, an edge in 2D.

    Device tensors:
      N       [n_f, n_q, n_local]        cell shape values at facet quad
                                         points
      grads   [n_f, g, n_local, dim]     cell shape gradients (g as in
                                         CellBatch)
      scale   [n_f, n_q]                 w_q * |facet| * (2*pi*r | 1)
      normal  [n_f, dim]                 outward unit normals
      x_q     [n_f, n_q, dim]
      dofs    [n_f, n_local]             adjacent-cell dofs
    """

    _FLOAT_FIELDS = ("N", "grads", "scale", "normal", "x_q")
    _GEOM_FIELDS = _FLOAT_FIELDS
    # the per-facet tables (N varies per facet here), what `local_view`
    # takes
    _SHARD_FIELDS = ("N", "grads", "scale", "normal", "x_q", "dofs")

    def __init__(self, space: FunctionSpace, markers=None,
                 quad_degree: int = 4, axisymmetric: bool = False,
                 dtype=None, *, device):
        dtype = torch.float64 if dtype is None else dtype
        mesh = space.mesh
        self.space = space
        self.dtype = dtype
        self.device = torch.device(device)
        if markers is None:
            sel = np.arange(len(mesh.boundary_facets))
        else:
            if isinstance(markers, int):
                markers = [markers]
            sel = np.where(np.isin(mesh.facet_markers, markers))[0]
        self.n_facets = len(sel)
        self.n_local = space.n_local
        self.n_dofs = space.n_dofs
        self.dim = dim = mesh.dim

        facets = mesh.boundary_facets[sel]
        cells_adj = mesh.boundary_cells[sel]
        cell_verts = mesh.cells[cells_adj]
        spts, wts = facet_quadrature(dim, quad_degree)
        self.n_q = len(wts)

        # facet quadrature points in the adjacent cell's reference coords
        ref_verts = (np.array([[0.0], [1.0]]) if dim == 1 else
                     np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]))
        local_idx = np.stack([np.argmax(cell_verts == facets[:, j:j + 1],
                                        axis=1)
                              for j in range(facets.shape[1])], axis=1)
        if dim == 1:
            ref_q = ref_verts[local_idx[:, 0]][:, None, :]
            measure = np.ones(self.n_facets)
        else:
            a_ref = ref_verts[local_idx[:, 0]]
            b_ref = ref_verts[local_idx[:, 1]]
            s = spts[:, 0]
            ref_q = (a_ref[:, None, :] * (1.0 - s)[None, :, None]
                     + b_ref[:, None, :] * s[None, :, None])
            measure = np.linalg.norm(mesh.coords[facets[:, 1]]
                                     - mesh.coords[facets[:, 0]], axis=1)

        N, grads, x_q, _ = _physical_tables(space, ref_q,
                                            mesh.coords[cell_verts])
        scale = wts[None, :] * measure[:, None]
        if axisymmetric:
            scale = scale * (2.0 * pi * x_q[:, :, 0])

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self.N = put(N)
        self.grads = put(grads)
        self.scale = put(scale)
        self.normal = put(mesh.facet_normals()[sel])
        self.x_q = put(x_q)
        self.dofs_np = space.cell_dofs[cells_adj]
        self.dofs = torch.as_tensor(self.dofs_np, device=self.device)

    def gather(self, u: torch.Tensor) -> torch.Tensor:
        return u[self.dofs]

    def value(self, u_e: torch.Tensor) -> torch.Tensor:
        return torch.einsum("fqa,fa...->fq...", self.N, u_e)

    def grad(self, u_e: torch.Tensor) -> torch.Tensor:
        g = torch.einsum("fqad,fa...->fqd...", self.grads, u_e)
        return g.expand((g.shape[0], self.n_q) + tuple(g.shape[2:]))

    def mass(self, s: torch.Tensor) -> torch.Tensor:
        """Boundary integral of s * phi_a: [n_f, n_q, ...] ->
        [n_f, n_local, ...]."""
        return torch.einsum("fqa,fq...->fa...", self.N,
                            s * _scale_like(self.scale, s))


def interpolate(fn, space: FunctionSpace, dtype=None, *,
                device) -> torch.Tensor:
    """Nodal interpolation: `fn(dof_coords) -> values` (or a number)
    evaluated in float64 numpy at the dof coordinates, as a [n_dofs]
    tensor on `device` (dolfin's `interpolate(Expression, V)` for
    Lagrange spaces)."""
    dtype = torch.float64 if dtype is None else dtype
    if callable(fn):
        vals = np.asarray(fn(space.dof_coords))
        if vals.ndim == 0:
            vals = np.full(space.n_dofs, float(vals))
    else:
        vals = np.full(space.n_dofs, float(fn))
    return torch.as_tensor(vals, dtype=dtype, device=torch.device(device))


def project(s_q: torch.Tensor, batch: CellBatch, lumped: bool = False,
            tol: float = None, maxiter: int = 200) -> torch.Tensor:
    """L2-project quadrature-point values `s_q [n_cells, n_q]` onto the
    batch's space: M x = b by Jacobi-preconditioned CG from the lumped
    answer (the reference's per-step `project(...)`), or with
    `lumped=True` the row-sum mass diagonal alone. The tolerance follows
    the batch's type: 1e-12 in float64, 1e-6 in float32. On the ELL layout
    every scatter is a dense K1 launch with one component."""
    if tol is None:
        tol = 1e-12 if batch.dtype == torch.float64 else 1e-6
    b = batch.scatter(batch.mass(s_q))
    lump = batch.scatter(batch.mass(torch.ones_like(batch.scale)))
    if lumped:
        return b / lump

    def matvec(x):
        return batch.scatter(batch.mass(batch.value(batch.gather(x))))

    from ..solvers.linear import cg

    x, _, _ = cg(matvec, b, x0=b / lump, precond=lambda r: r / lump,
                 tol=tol, maxiter=maxiter)
    return x


def vector_l2_norm(u: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of the flattened dof vector (dolfin's
    `norm(v.vector())`)."""
    return torch.linalg.vector_norm(u.reshape(-1))
