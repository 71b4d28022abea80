"""Time-of-flight verification models (method of exact solutions), the JAX
package's `models/tof.py`:

- 1D electron swarm, P2 elements, planar (the reference's
  `examples/time_of_flight_1D/fedm-tof_1d.py`): drift-diffusion-reaction in
  log form, fixed dt, BDF1 bootstrap then BDF2;
- 2D axisymmetric swarm, P1 (the reference's test configuration
  `tests/integrated_tests/time_of_flight/fedm_tof.py:63-95`).

The drifting, diffusing, ionising Gaussian has the exact solution

  n(z, t) = exp(-((z - x0 - w t)/l)^2 / s(t) + alpha w t) / sqrt(s(t)),
  s(t) = 1 + 4 D t / l^2,

and the relative L2 error against it is the verification gate (the
reference pins 0.128997... for the 2D configuration). The source term is
f = alpha w n(z, t), evaluated analytically as the reference does.

Nothing here switches the batch to another scatter layout: the cell
scatter is the ELL gather-sum (K1's dense form), built at first use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from .._device import resolve_device
from ..fem import CellBatch, FunctionSpace
from ..fem.assembly import project
from ..fem.dirichlet import BCSet
from ..mesh import interval_mesh, rectangle_mesh
from ..model.forms import balance_equation_contrib, drift_diffusion_flux
from ..model.system import CoupledSystem, StepParams
from ..solvers.newton import NewtonConfig


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


@dataclass
class TofConfig:
    wez: float = 1.7e5       # drift velocity z-component [m/s]
    De: float = 0.12         # diffusion coefficient [m^2/s]
    alpha: float = 5009.51   # effective ionisation coefficient [1/m]
    x0: float = 3e-4         # initial Gaussian centre [m]
    l: float = 4e-5          # Gaussian width [m]
    dt: float = 1e-11
    t0: float = 0.0
    T_final: float = 3e-9
    # Density floor of the initial state, relative to the Gaussian's peak:
    # an iterative solver needs the analytic tail (down to exp(-306))
    # floored; it contributes O(n_floor) to the relative L2 error.
    n_floor: float = 1e-8
    newton: NewtonConfig = field(default_factory=lambda: NewtonConfig(
        rtol=1e-10, max_iter=50, linear_tol=1e-10, linear_maxiter=2000))


class _TofBase:
    """Shared machinery; subclasses provide the mesh and space and the
    index of the drift (z) coordinate."""

    axisymmetric: bool
    z_axis: int

    def __init__(self, cfg: TofConfig, space: FunctionSpace,
                 quad_degree: int, err_quad_degree: int = None, *,
                 device):
        self.cfg = cfg
        self.space = space
        self.device = resolve_device(device)
        self.batch = CellBatch(space, quad_degree=quad_degree,
                               axisymmetric=self.axisymmetric,
                               device=self.device)
        bcs = BCSet(space, 1, [], device=self.device)
        self.system = CoupledSystem(self.batch, 1, bcs, cfg.newton)
        self.system.set_cell_kernel(self._cell_kernel)
        # the error norm integrates the plain (cartesian) measure, at the
        # reference error metric's own quadrature (its projections of
        # exp(u) are integrated at degree 4), separate from assembly's
        eq = quad_degree if err_quad_degree is None else err_quad_degree
        self._err_batch = (CellBatch(space, quad_degree=eq,
                                     axisymmetric=False, device=self.device)
                           if (self.axisymmetric or eq != quad_degree)
                           else self.batch)
        # NewtonInfo of every step of the last `run`
        self.step_infos = []

    def u_analytic(self, points, t):
        raise NotImplementedError

    def n_analytic(self, points, t):
        return torch.exp(self.u_analytic(points, t))

    def _cell_kernel(self, cb: CellBatch, delta_e, ctx):
        c = self.cfg
        p: StepParams = ctx["params"]
        u1 = ctx["u_old"][..., 0] + delta_e[..., 0]
        ones = torch.ones(u1.shape[:2], dtype=u1.dtype, device=u1.device)
        D_e = c.De * ones
        mu_e = ones
        # the drift term sign*mu*E is w e_z (the reference builds Gamma
        # with the drift velocity)
        w_vec = torch.zeros((1, 1, cb.x_q.shape[-1]), dtype=u1.dtype,
                            device=u1.device)
        w_vec[..., self.z_axis] = c.wez
        E_q = w_vec.expand(cb.x_q.shape)
        Gamma_q = drift_diffusion_flux(cb, u1, D_e, mu_e, E_q, sign=1.0,
                                       grad_diffusion=True)
        f_q = c.alpha * c.wez * self.n_analytic(cb.x_q, p.t)
        contrib = balance_equation_contrib(
            cb, "drift-diffusion-reaction", delta_e[..., 0],
            ctx["u_old"][..., 0], ctx["d_hist"][..., 0], p.dt, p.dt_old,
            f_q, Gamma_q=Gamma_q)
        return contrib[..., None]

    def relative_l2_error(self, u: torch.Tensor, t: float) -> float:
        """errornorm(n_num, n_exact)/norm(n_exact) as the reference
        computes it: exp(u) and the exact solution are L2-projected onto
        the space first, and the norms use the cartesian measure."""
        eb = self._err_batch
        n_num = project(torch.exp(eb.value(eb.gather(u[:, 0]))), eb)
        n_ex = project(self.n_analytic(eb.x_q, t), eb)
        d_q = eb.value(eb.gather(n_num - n_ex))
        e_q = eb.value(eb.gather(n_ex))
        return float(torch.sqrt(eb.integrate(d_q ** 2)
                                / eb.integrate(e_q ** 2)))

    def initial_state(self) -> torch.Tensor:
        pts = torch.as_tensor(self.space.dof_coords, dtype=torch.float64,
                              device=self.device)
        u0 = self.u_analytic(pts, self.cfg.t0)[:, None]
        # floored relative to the peak (TofConfig.n_floor)
        return torch.maximum(u0, u0.max() + math.log(self.cfg.n_floor))

    def run(self, output_times: Optional[List[float]] = None,
            ) -> Tuple[torch.Tensor, List[Tuple[float, float]]]:
        """The reference's fixed-dt loop: a BDF1 first step (dt_old huge),
        BDF2 after it. Returns the final state and [(t, relative L2
        error)] at the output times; `step_infos` holds each step's
        NewtonInfo."""
        c = self.cfg
        u = self.initial_state()
        u_old = u
        t = c.t0
        dt_old = 1e30
        errors = []
        self.step_infos = []
        out_times = list(output_times or [c.T_final])
        next_out = 0
        n_steps = int(round((c.T_final - c.t0) / c.dt))
        for _ in range(n_steps):
            u_old1, u_old = u_old, u
            t = t + c.dt
            u, info = self.system.step(u_old, u_old, u_old1, {},
                                       StepParams(t, c.dt, dt_old))
            self.step_infos.append(info)
            if not info.converged:
                raise RuntimeError(
                    f"ToF Newton failed at t={t}: |F|={info.res_norm}")
            if next_out < len(out_times) and (
                    abs(t - out_times[next_out]) <= 0.51 * c.dt):
                errors.append((t, self.relative_l2_error(u, t)))
                next_out += 1
            dt_old = c.dt  # BDF1 -> BDF2 after the first step
        return u, errors


class TimeOfFlight1D(_TofBase):
    """1D planar swarm on [0, box_height], P2 elements (the reference's
    IntervalMesh(4000) on a 1e-3 m box)."""

    axisymmetric = False
    z_axis = 0

    def u_analytic(self, points, t):
        """The drifting, diffusing, ionising 1D Gaussian in log form."""
        c = self.cfg
        z = points[..., 0]
        s = 1.0 + 4.0 * c.De * t / c.l ** 2
        return (-(((z - c.x0 - c.wez * t) / c.l) ** 2) / s
                + c.alpha * c.wez * t - 0.5 * _log(s))

    def __init__(self, cfg: TofConfig = None, n_cells: int = 4000,
                 box_height: float = 1e-3, degree: int = 2,
                 quad_degree: int = 6, device="cuda"):
        cfg = cfg or TofConfig()
        mesh = interval_mesh(n_cells, 0.0, box_height)
        super().__init__(cfg, FunctionSpace(mesh, degree), quad_degree,
                         device=device)


class TimeOfFlight2D(_TofBase):
    """2D axisymmetric swarm on [0, w] x [0, h], P1 elements, drift along
    x[1] = z (the reference's test configuration: 40 x 40 on
    2.5e-4 x 5e-4 m, dt 1e-12, t in [2.5e-9, 2.6e-9])."""

    axisymmetric = True
    z_axis = 1

    def u_analytic(self, points, t):
        """The 3D point-source Gaussian in cylindrical (r, z), log form."""
        c = self.cfg
        r, z = points[..., 0], points[..., 1]
        return (-((z - c.wez * t) ** 2 + r ** 2) / (4.0 * c.De * t)
                + c.alpha * c.wez * t
                - 1.5 * _log(4.0 * math.pi * c.De * t))

    def __init__(self, cfg: TofConfig = None, nx: int = 40, ny: int = 40,
                 box_width: float = 2.5e-4, box_height: float = 5e-4,
                 degree: int = 1, quad_degree: int = 6,
                 err_quad_degree: int = 4, device="cuda"):
        # quadrature 6 is converged for assembly; 4 is the reference
        # error metric's own projection quadrature: together they give
        # the reference's pinned L2 error to +0.035%
        cfg = cfg or TofConfig(t0=2.5e-9, T_final=2.6e-9, dt=1e-12)
        mesh = rectangle_mesh((0, 0), (box_width, box_height), nx, ny)
        super().__init__(cfg, FunctionSpace(mesh, degree), quad_degree,
                         err_quad_degree, device=device)
