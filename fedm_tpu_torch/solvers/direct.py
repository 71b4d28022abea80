"""Host sparse-direct Newton: the rescue for steps the Krylov Newton refuses
(the JAX package's `solvers/direct.py`, the reference's MUMPS role).

At some states (the Bagheri post-arrival cathode sheath) no Krylov
configuration gives a useful direction. `DirectNewton` solves those steps
with exact linear solves, dividing the work as the JAX package does:

- **Jacobian by coloured probing on the device.** Dof columns are grouped
  by a greedy distance-2 colouring of the node adjacency (host numpy, once
  per topology: window moves keep it), so no two columns of one colour
  share a residual row. `n_colors * n_eq` Jacobian actions of the system's
  `StepOperators`, in the compute dtype, recover every entry of the
  Jacobian of the delta-residual exactly.
- **Factorization on the host.** The probes come back to the host, are
  scattered into a float64 CSC matrix and factored by SuperLU
  (`scipy.sparse.linalg.splu`); the right-hand side and the backtracking
  norms are the float64 defect when the system has `hi_residual`.
- **Escalation, not replacement.** It plugs into
  `AdaptiveDriver(fallback_system=...)`: only steps the primary Newton
  refused pay the host cost.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .newton import NewtonInfo


def build_adjacency_pairs(cell_dofs: np.ndarray, n_dofs: int):
    """Unique (row, col) node pairs coupled by at least one cell: the
    block-sparsity pattern of the assembled Jacobian. `cell_dofs`
    [n_cells, n_local]."""
    cd = np.asarray(cell_dofs)
    n_local = cd.shape[1]
    m = np.repeat(cd, n_local, axis=1).ravel()
    n = np.tile(cd, (1, n_local)).ravel()
    codes = np.unique(m.astype(np.int64) * n_dofs + n)
    return codes // n_dofs, codes % n_dofs


def greedy_distance2_coloring(mm: np.ndarray, nn: np.ndarray,
                              n_dofs: int) -> np.ndarray:
    """Greedy colouring in which any two nodes within distance 2 of the
    adjacency graph differ: the condition for collision-free column
    probing (two same-colour columns never share a residual row). Input:
    the unique adjacency pairs."""
    order = np.argsort(mm, kind="stable")
    nn_s = nn[order]
    starts = np.searchsorted(mm[order], np.arange(n_dofs + 1))
    colors = np.full(n_dofs, -1, dtype=np.int64)
    for v in range(n_dofs):
        forbidden = set()
        for u in nn_s[starts[v]:starts[v + 1]]:
            cu = colors[u]
            if cu >= 0:
                forbidden.add(cu)
            for w in nn_s[starts[u]:starts[u + 1]]:
                cw = colors[w]
                if cw >= 0:
                    forbidden.add(cw)
        c = 0
        while c in forbidden:
            c += 1
        colors[v] = c
    return colors


class DirectNewton:
    """`AdaptiveDriver`-compatible nonlinear solver (`.step(...)`): Newton
    with exact sparse linear solves on the host and the Jacobian recovered
    by coloured probing on the system's device.

    The colouring, the sparsity indices and the probe seeds are built on
    first use and survive geometry updates of the system (same topology by
    contract). Counters: `n_factorizations`, `n_probes`, `probe_s` and
    `factor_s` (host seconds of probing and of `splu`), `nnz` of the last
    matrix, and `history`, the residual norm at the start and after each
    accepted iteration of the last step."""

    def __init__(self, system, max_iter: int = 10,
                 rtol: Optional[float] = None, atol: float = 0.0,
                 backtracks: int = 6,
                 accept_reduction: Optional[float] = None,
                 verbose: bool = False):
        self.system = system
        self.max_iter = max_iter
        self.rtol = system.newton.rtol if rtol is None else rtol
        self.atol = atol
        self.backtracks = backtracks
        # stall acceptance as in `newton_converged`: keep an iterate that
        # stopped short of rtol if it reduced ||F|| by this factor
        self.accept_reduction = (system.newton.accept_reduction
                                 if accept_reduction is None
                                 else accept_reduction)
        self.verbose = verbose
        self._topo = None
        self._seeds = None
        self.n_factorizations = 0
        self.n_probes = 0
        self.probe_s = 0.0
        self.factor_s = 0.0
        self.nnz = 0
        self.history = []

    # the driver reads `.newton.host_loop` to decide on a predicted guess;
    # `step` anchors its target to ||R(0)|| as the host loop does
    @property
    def newton(self):
        return self.system.newton

    @property
    def n_colors(self) -> int:
        self.prepare()
        return self._topo[5]

    def prepare(self, colors: Optional[np.ndarray] = None) -> None:
        """Build the topology and the seeds (once). `colors` replaces the
        distance-2 colouring (a wrong one gives a wrong matrix)."""
        if self._topo is not None and colors is None:
            return
        sys_ = self.system
        n_dofs, n_eq = sys_.n_dofs, sys_.n_eq
        mm, nn = build_adjacency_pairs(sys_.cell_batch.dofs_np, n_dofs)
        if colors is None:
            colors = greedy_distance2_coloring(mm, nn, n_dofs)
        n_colors = int(colors.max()) + 1
        # flat COO indices of every block entry J[(m, p), (n, q)]; its
        # value is probe color[n] * n_eq + q at row m, column p
        shape = (len(mm), n_eq, n_eq)
        p = np.arange(n_eq)
        rows = np.broadcast_to(mm[:, None, None] * n_eq + p[:, None],
                               shape).ravel()
        cols = np.broadcast_to(nn[:, None, None] * n_eq + p[None, :],
                               shape).ravel()
        seed_id = np.broadcast_to(colors[nn][:, None, None] * n_eq
                                  + p[None, None, :], shape).ravel()
        m_flat = np.broadcast_to(mm[:, None, None], shape).ravel()
        p_flat = np.broadcast_to(p[None, :, None], shape).ravel()
        self._topo = (rows, cols, seed_id, m_flat, p_flat, n_colors,
                      len(mm))
        dev = sys_.bcs.mask.device
        self._seeds = []
        for c in range(n_colors):
            sel = torch.as_tensor(colors == c, device=dev)
            for q in range(n_eq):
                s = torch.zeros((n_dofs, n_eq), dtype=sys_.dtype, device=dev)
                s[sel, q] = 1.0
                self._seeds.append(s)
        if self.verbose:
            print(f"  direct: {n_colors} colors x {n_eq} eqs = "
                  f"{n_colors * n_eq} probes, {len(mm)} node pairs",
                  flush=True)

    @property
    def n_pairs(self) -> int:
        self.prepare()
        return self._topo[6]

    def assemble(self, ops, delta: torch.Tensor):
        """The exact sparse Jacobian (float64 CSC) of `ops.residual` at
        `delta`: one Jacobian action per seed in the compute dtype, each
        brought to the host and converted there."""
        import scipy.sparse as sp

        self.prepare()
        rows, cols, seed_id, m_flat, p_flat = self._topo[:5]
        t0 = time.perf_counter()
        jvp = ops.jacobian_action(delta)
        probes = np.stack([jvp(s).cpu().numpy() for s in self._seeds])
        self.probe_s += time.perf_counter() - t0
        self.n_probes += len(self._seeds)
        data = probes[seed_id, m_flat, p_flat].astype(np.float64)
        n = self.system.n_dofs * self.system.n_eq
        return sp.csc_matrix((data, (rows, cols)), shape=(n, n))

    def step(self, u_guess, u_old, u_old1, aux, params):
        from scipy.sparse.linalg import splu

        sys_ = self.system
        ops = sys_.operators(u_old, u_old1, params, aux=aux)
        residual = (sys_.operators(u_old, u_old1, params, torch.float64,
                                   aux).residual
                    if sys_._hi_enabled() else ops.residual)
        n_eq = sys_.n_eq

        def rnorm(d):
            r = residual(d).cpu().numpy().astype(np.float64)
            return r, float(np.linalg.norm(r))

        delta = (u_guess - u_old).to(sys_.dtype)
        r, f0 = rnorm(delta)
        if u_guess is not u_old:
            # a predicted guess: the target stays anchored to ||R(0)||
            zero = torch.zeros_like(delta)
            r00, f00 = rnorm(zero)
            if not np.isfinite(f0) or f0 >= f00:
                delta, r, f0 = zero, r00, f00
            target = max(self.rtol * f00, self.atol)
            f0 = min(f0, f00)
        else:
            target = max(self.rtol * f0, self.atol)
        fnorm, k = f0, 0
        self.history = [f0]
        while fnorm > target and k < self.max_iter and np.isfinite(fnorm):
            J = self.assemble(ops, delta)
            self.nnz = J.nnz
            t0 = time.perf_counter()
            try:
                lu = splu(J)
            except RuntimeError:        # exactly singular: give up
                break
            finally:
                self.factor_s += time.perf_counter() - t0
            self.n_factorizations += 1
            d = lu.solve(-r.reshape(-1)).reshape(-1, n_eq)
            if not np.isfinite(d).all():
                break
            d_dev = torch.as_tensor(d, dtype=sys_.dtype, device=delta.device)
            # backtracking on the (float64 defect's) norm
            alpha, accepted = 1.0, False
            for _ in range(self.backtracks):
                r_try, f_try = rnorm(delta + alpha * d_dev)
                if np.isfinite(f_try) and f_try < fnorm:
                    delta = delta + alpha * d_dev
                    r, fnorm = r_try, f_try
                    accepted = True
                    break
                alpha *= 0.5
            k += 1
            if self.verbose:
                print(f"  direct newton: it={k} |F| {f0:.3e} -> "
                      f"{fnorm:.3e} (target {target:.3e}, "
                      f"alpha={alpha if accepted else 0.0:g})", flush=True)
            if not accepted:
                break
            self.history.append(fnorm)
        strict = bool(fnorm <= target)
        converged = strict or (self.accept_reduction > 0
                               and bool(np.isfinite(fnorm))
                               and fnorm <= self.accept_reduction * f0)
        info = NewtonInfo(converged, k, fnorm, f0, 0.0,
                          converged and not strict)
        return u_old + delta.to(u_old.dtype), info
