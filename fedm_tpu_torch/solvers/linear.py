"""Matrix-free preconditioned Krylov solvers on torch tensors.

Ports of the JAX package's `solvers/linear.py`: vectors may have any shape
(dot products flatten), inner products and norms are range-scaled float64
reductions whatever the field dtype, scalars of the recurrences stay
float64 on the device, and the loop condition is read on the host once per
iteration. Every solver returns `(x, relres, iters)` with `relres` a float64
0-dim tensor; a failed solve is reported by `relres`, never an exception.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

_F64 = torch.float64
# breakdown threshold for rho/omega/denominator guards: the float64 range
# floor (the reference's choice off the TPU, where float64 is native)
TINY = 1e-290


def _scale_of(af: torch.Tensor) -> torch.Tensor:
    s = af.abs().max()
    return torch.where((s > 0) & torch.isfinite(s), s, 1.0)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float64 inner product, range-scaled: both vectors are normalised by
    their max magnitudes first, and the smaller scale is multiplied in
    before the larger, so no intermediate leaves the range the result
    needs (the JAX package's `_dot`)."""
    af = a.reshape(-1).to(_F64)
    bf = b.reshape(-1).to(_F64)
    sa, sb = _scale_of(af), _scale_of(bf)
    s_min, s_max = torch.minimum(sa, sb), torch.maximum(sa, sb)
    return s_max * (torch.dot(af / sa, bf / sb) * s_min)


def _norm(a: torch.Tensor) -> torch.Tensor:
    """float64 2-norm that never forms the unscaled sum of squares."""
    af = a.reshape(-1).to(_F64)
    sa = _scale_of(af)
    an = af / sa
    return sa * torch.sqrt(torch.dot(an, an))


def _identity(x):
    return x


def _where_small(x: torch.Tensor, tiny: float) -> torch.Tensor:
    """x, or 1 where |x| < tiny (the breakdown guard of a denominator)."""
    return torch.where(x.abs() < tiny, 1.0, x)


def cg(matvec: Callable, b: torch.Tensor,
       x0: Optional[torch.Tensor] = None,
       precond: Optional[Callable] = None, tol: float = 1e-10,
       atol: float = 0.0, maxiter: int = 1000):
    """Preconditioned conjugate gradients for SPD operators. The two
    denominators are guarded by the float64 floor TINY, which only an
    exactly zero p.Ap or r.z reaches: on an SPD system the iterates are the
    JAX package's `cg`."""
    M = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = M(r)
    rz = _dot(r, p)
    bnorm = float(torch.clamp(_norm(b), min=1e-300))
    target = max(tol * bnorm, atol)
    k = 0
    dt = x.dtype
    while float(_norm(r)) > target and k < maxiter:
        Ap = matvec(p)
        alpha = (rz / _where_small(_dot(p, Ap), TINY)).to(dt)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = (rz_new / _where_small(rz, TINY)).to(dt)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, _norm(r) / bnorm, k


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None,
             precond: Optional[Callable] = None, tol: float = 1e-8,
             maxiter: int = 1000, stall_window: int = 0,
             stall_factor: float = 0.99):
    """Right-preconditioned BiCGStab. Breakdown (rho or omega underflow)
    exits early. `stall_window > 0` exits after that many iterations
    without the residual dropping below `stall_factor` times its best."""
    M = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    one = torch.ones((), dtype=_F64, device=b.device)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    bnorm = float(torch.clamp(_norm(b), min=1e-300))
    target = tol * bnorm
    rnorm = _norm(r)
    best = rnorm
    window = stall_window if stall_window > 0 else maxiter + 1
    k, since, broke = 0, 0, False
    dt = x.dtype
    while float(rnorm) > target and k < maxiter and not broke \
            and since < window:
        rho_new = _dot(rhat, r)
        breakdown = rho_new.abs() < TINY
        beta = ((rho_new / torch.where(breakdown, 1.0, rho))
                * (alpha / _where_small(omega, TINY)))
        p = r + beta.to(dt) * (p - omega.to(dt) * v)
        phat = M(p)
        v = matvec(phat)
        denom = _dot(rhat, v)
        breakdown = breakdown | (denom.abs() < TINY)
        alpha = rho_new / torch.where(breakdown, 1.0, denom)
        s = r - alpha.to(dt) * v
        shat = M(s)
        t = matvec(shat)
        tt = _dot(t, t)
        omega = _dot(t, s) / torch.where(tt < TINY, 1.0, tt)
        x = x + alpha.to(dt) * phat + omega.to(dt) * shat
        r = s - omega.to(dt) * t
        rho = rho_new
        rnorm = _norm(r)
        if stall_window > 0:
            improved = bool(rnorm < stall_factor * best)
            best = torch.minimum(best, torch.where(torch.isfinite(rnorm),
                                                   rnorm, best))
            since = 0 if improved else since + 1
        broke = bool(breakdown)
        k += 1
    return x, rnorm / bnorm, k


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None,
          precond: Optional[Callable] = None, tol: float = 1e-8,
          maxiter: int = 1000, restart: int = 30,
          stall_window: int = 0, stall_factor: float = 0.99):
    """Restarted GMRES(m) with right preconditioning and Givens rotations;
    the monitored residual is the true one. The small Hessenberg problem is
    solved in float64 on the host. `stall_window > 0` adds the plateau exit
    of `bicgstab` inside a cycle and a cycle-level stagnation exit."""
    M = precond or _identity
    m = restart
    window = stall_window if stall_window > 0 else maxiter + 1
    shape = b.shape
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = float(torch.clamp(_norm(b), min=1e-300))
    target = tol * bnorm

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = float(_norm(r))
        V = torch.zeros((m + 1, b.numel()), dtype=b.dtype, device=b.device)
        V[0] = (r / max(beta, TINY)).reshape(-1)
        g = np.zeros(m + 1)
        g[0] = beta
        H = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        j, res, best, since = 0, beta, beta, 0
        while j < m and res > target and since < window:
            w = matvec(M(V[j].reshape(shape))).reshape(-1)
            hcol = np.zeros(m + 1)
            # modified Gram-Schmidt against V[0..j]
            for k in range(j + 1):
                hk = float(_dot(V[k], w))
                w = w - hk * V[k]
                hcol[k] = hk
            hj1 = float(_norm(w))
            V[j + 1] = w / max(hj1, TINY)
            hcol[j + 1] = hj1
            for k in range(j):  # previously accumulated rotations
                a0, a1 = hcol[k], hcol[k + 1]
                hcol[k] = cs[k] * a0 + sn[k] * a1
                hcol[k + 1] = -sn[k] * a0 + cs[k] * a1
            denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            safe = max(denom, TINY)
            c, s = hcol[j] / safe, hcol[j + 1] / safe
            cs[j], sn[j] = c, s
            hcol[j], hcol[j + 1] = denom, 0.0
            H[:, j] = hcol
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            res = abs(g[j + 1])
            improved = res < stall_factor * best
            if np.isfinite(res):
                best = min(best, res)
            since = 0 if improved else since + 1
            j += 1
        # back substitution on the leading j x j triangle
        y = np.zeros(m)
        for k in range(j - 1, -1, -1):
            hkk = H[k, k]
            y[k] = (g[k] - H[k, :m] @ y) / (1.0 if abs(hkk) < TINY else hkk)
        yt = torch.as_tensor(y, dtype=b.dtype, device=b.device)
        z = (yt @ V[:m]).reshape(shape)
        return x + M(z), res, j

    r0 = float(_norm(b - matvec(x)))
    res, k, stagnant = r0, 0, False
    while res > target and k < maxiter and not stagnant:
        res_prev = res
        x, res, j = arnoldi_cycle(x)
        stagnant = stall_window > 0 and res >= stall_factor * res_prev
        k += j
    return x, torch.tensor(res / bnorm, dtype=_F64), k


# -- batched solvers: B independent systems on a leading member axis --------
#
# Each member has its own scalars (rho, alpha, omega, the Hessenberg
# problem), its own norms and its own stopping; the loop runs until every
# member has stopped, and a stopped member's iterate is not touched again
# (what `vmap` of the JAX package's `lax.while_loop` computes). Vectors are
# [B, ...]; `matvec` and `precond` map [B, ...] to [B, ...] with no
# coupling between members. The dots and norms reduce over each member's
# entries and return [B]; the stop mask is read on the host once per
# iteration.


def _col(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-member scalars s [B] against x [B, ...], in x's dtype."""
    return s.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def _rows(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1).to(_F64)


def _scale_b(af: torch.Tensor) -> torch.Tensor:
    s = af.abs().amax(dim=1)
    return torch.where((s > 0) & torch.isfinite(s), s, 1.0)


def dot_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`_dot` of each member: [B, ...] x [B, ...] -> [B] float64."""
    af, bf = _rows(a), _rows(b)
    sa, sb = _scale_b(af), _scale_b(bf)
    s_min, s_max = torch.minimum(sa, sb), torch.maximum(sa, sb)
    return s_max * (((af / sa[:, None]) * (bf / sb[:, None])).sum(dim=1)
                    * s_min)


def norm_b(a: torch.Tensor) -> torch.Tensor:
    """`_norm` of each member: [B, ...] -> [B] float64."""
    af = _rows(a)
    sa = _scale_b(af)
    an = af / sa[:, None]
    return sa * torch.sqrt((an * an).sum(dim=1))


def finite_b(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [B] bool: every entry of the member finite."""
    return torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=1)


def _where_b(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per member, `a` where m [B] else `b` (any shapes [B, ...])."""
    return torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def bicgstab_batched(matvec: Callable, b: torch.Tensor,
                     x0: Optional[torch.Tensor] = None,
                     precond: Optional[Callable] = None, tol: float = 1e-8,
                     maxiter: int = 1000, stall_window: int = 0,
                     stall_factor: float = 0.99,
                     active: Optional[np.ndarray] = None):
    """`bicgstab` of B independent systems b [B, ...]. `active` [B] bool
    (default all): the members that solve; the others keep x0 (zero) and
    report relres 1. Returns (x, relres [B] float64 tensor, iters [B]
    numpy)."""
    M = precond or _identity
    B, dev = b.shape[0], b.device
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    one = torch.ones(B, dtype=_F64, device=dev)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    bnorm = torch.clamp(norm_b(b), min=1e-300)
    target = tol * bnorm
    rnorm = norm_b(r)
    best = rnorm
    window = stall_window if stall_window > 0 else maxiter + 1
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    since = torch.zeros_like(k)
    broke = torch.zeros(B, dtype=torch.bool, device=dev)
    act = torch.as_tensor(np.ones(B, bool) if active is None else active,
                          device=dev)
    run = act & (rnorm > target) & (k < maxiter)
    while bool(run.any()):
        rho_new = dot_b(rhat, r)
        breakdown = rho_new.abs() < TINY
        beta = ((rho_new / torch.where(breakdown, 1.0, rho))
                * (alpha / _where_small(omega, TINY)))
        p_n = r + _col(beta, p) * (p - _col(omega, v) * v)
        phat = M(p_n)
        v_n = matvec(phat)
        denom = dot_b(rhat, v_n)
        breakdown = breakdown | (denom.abs() < TINY)
        alpha_n = rho_new / torch.where(breakdown, 1.0, denom)
        s = r - _col(alpha_n, v_n) * v_n
        shat = M(s)
        t = matvec(shat)
        tt = dot_b(t, t)
        omega_n = dot_b(t, s) / torch.where(tt < TINY, 1.0, tt)
        x_n = x + _col(alpha_n, phat) * phat + _col(omega_n, shat) * shat
        r_n = s - _col(omega_n, t) * t
        rnorm_n = norm_b(r_n)
        # commit the running members only
        x, r, p, v = (_where_b(run, x_n, x), _where_b(run, r_n, r),
                      _where_b(run, p_n, p), _where_b(run, v_n, v))
        rho = torch.where(run, rho_new, rho)
        alpha = torch.where(run, alpha_n, alpha)
        omega = torch.where(run, omega_n, omega)
        rnorm = torch.where(run, rnorm_n, rnorm)
        if stall_window > 0:
            improved = rnorm < stall_factor * best
            best_n = torch.minimum(best, torch.where(torch.isfinite(rnorm),
                                                     rnorm, best))
            best = torch.where(run, best_n, best)
            since = torch.where(run, torch.where(improved, 0, since + 1),
                                since)
        broke = torch.where(run, breakdown, broke)
        k = k + run.to(k.dtype)
        run = run & (rnorm > target) & (k < maxiter) & ~broke & (since
                                                                  < window)
    return x, rnorm / bnorm, k.cpu().numpy()


def gmres_batched(matvec: Callable, b: torch.Tensor,
                  x0: Optional[torch.Tensor] = None,
                  precond: Optional[Callable] = None, tol: float = 1e-8,
                  maxiter: int = 1000, restart: int = 30,
                  stall_window: int = 0, stall_factor: float = 0.99,
                  active: Optional[np.ndarray] = None):
    """`gmres` of B independent systems b [B, ...], each member with its
    own Hessenberg problem (solved on the host in float64), cycle and
    stopping; the members still iterating advance in lockstep, so they
    share the Arnoldi index. `active` as in `bicgstab_batched`. Returns
    (x, relres [B] float64 tensor, iters [B] numpy)."""
    M = precond or _identity
    m = restart
    window = stall_window if stall_window > 0 else maxiter + 1
    B, dev = b.shape[0], b.device
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = np.maximum(norm_b(b).cpu().numpy(), 1e-300)
    target = tol * bnorm
    act = np.ones(B, bool) if active is None else np.asarray(active, bool)

    def host(t):
        return t.cpu().numpy()

    def arnoldi_cycle(x, on):
        r = b - matvec(x)
        beta = host(norm_b(r))
        V = torch.zeros((m + 1,) + tuple(b.shape), dtype=b.dtype,
                        device=dev)
        V[0] = r / _col(torch.as_tensor(np.maximum(beta, TINY), device=dev),
                        r)
        g = np.zeros((B, m + 1))
        g[:, 0] = beta
        H = np.zeros((B, m + 1, m))
        cs, sn = np.zeros((B, m)), np.zeros((B, m))
        res, best = beta.copy(), beta.copy()
        since = np.zeros(B, int)
        jb = np.zeros(B, int)
        run = on & (res > target)
        j = 0
        while j < m and run.any():
            w = matvec(M(V[j]))
            hcol = np.zeros((B, m + 1))
            # modified Gram-Schmidt against V[0..j]
            for k in range(j + 1):
                hk = host(dot_b(V[k], w))
                w = w - _col(torch.as_tensor(hk, device=dev), w) * V[k]
                hcol[:, k] = hk
            hj1 = host(norm_b(w))
            run_t = torch.as_tensor(run, device=dev)
            V[j + 1] = _where_b(run_t, w / _col(torch.as_tensor(
                np.maximum(hj1, TINY), device=dev), w), V[j + 1])
            hcol[:, j + 1] = hj1
            for k in range(j):  # previously accumulated rotations
                a0, a1 = hcol[:, k].copy(), hcol[:, k + 1].copy()
                hcol[:, k] = cs[:, k] * a0 + sn[:, k] * a1
                hcol[:, k + 1] = -sn[:, k] * a0 + cs[:, k] * a1
            denom = np.sqrt(hcol[:, j] ** 2 + hcol[:, j + 1] ** 2)
            safe = np.maximum(denom, TINY)
            c, s = hcol[:, j] / safe, hcol[:, j + 1] / safe
            hcol[:, j], hcol[:, j + 1] = denom, 0.0
            # commit the running members only
            cs[run, j], sn[run, j] = c[run], s[run]
            H[run, :, j] = hcol[run]
            g_j = g[:, j].copy()
            g[run, j + 1] = -s[run] * g_j[run]
            g[run, j] = c[run] * g_j[run]
            res_n = np.abs(g[:, j + 1])
            improved = res_n < stall_factor * best
            res = np.where(run, res_n, res)
            best = np.where(run & np.isfinite(res_n),
                            np.minimum(best, res_n), best)
            since = np.where(run, np.where(improved, 0, since + 1), since)
            jb += run
            j += 1
            run = run & (jb < m) & (res > target) & (since < window)
        # back substitution on each member's leading jb x jb triangle
        y = np.zeros((B, m))
        for i in range(B):
            for k in range(jb[i] - 1, -1, -1):
                hkk = H[i, k, k]
                y[i, k] = ((g[i, k] - H[i, k, :m] @ y[i])
                           / (1.0 if abs(hkk) < TINY else hkk))
        yt = torch.as_tensor(y, dtype=b.dtype, device=dev)
        z = torch.einsum("bk,kb...->b...", yt, V[:m])
        return x + M(z), res, jb

    r0 = host(norm_b(b - matvec(x)))
    res = r0.copy()
    k = np.zeros(B, int)
    stagnant = np.zeros(B, bool)
    outer = act & (res > target) & (k < maxiter)
    while outer.any():
        res_prev = res.copy()
        x_n, res_c, j = arnoldi_cycle(x, outer)
        x = _where_b(torch.as_tensor(outer, device=dev), x_n, x)
        res = np.where(outer, res_c, res)
        k = k + np.where(outer, j, 0)
        if stall_window > 0:
            stagnant = stagnant | (outer & (res >= stall_factor * res_prev))
        outer = act & (res > target) & (k < maxiter) & ~stagnant
    return x, torch.as_tensor(res / bnorm, dtype=_F64), k
