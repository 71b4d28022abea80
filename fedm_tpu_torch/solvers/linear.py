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
