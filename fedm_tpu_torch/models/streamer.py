"""Positive streamer in air — the Bagheri et al. benchmark (Plasma Sources
Sci. Technol. 27 (2018) 095002), local field approximation:

  u[:, 0] = ln n_ion   (reaction — immobile ions)
  u[:, 1] = ln n_e     (drift-diffusion-reaction, log form)
  u[:, 2] = Phi        (Poisson)

on an axisymmetric (r, z) box, U = 18.75 kV across 1.25 cm at 760 Torr,
with closed-form transport and ionisation coefficients of the field
magnitude (`fedm-streamer.py:237-239`) evaluated at quadrature points inside
the residual.

This module ports the restart path of the JAX package's
`models/streamer.py`: the configuration, the corridor-refined tensor-product
mesh, the cell and electrode kernels, the structured z-line multigrid on the
Poisson row, and the far-field density floor. Building the initial state,
the moving window and the reference-format input reader are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..constants import elementary_charge, epsilon_0
from ..fem import BCSet, CellBatch, DirichletBC, FacetBatch, FunctionSpace
from ..mesh import Mesh, mark_boundaries, rectangle_mesh
from ..model.forms import balance_equation_contrib
from ..model.system import CoupledSystem
from ..ops.exprs import compile_expression
from ..solvers.newton import NewtonConfig
from ..solvers.stencil import canonical_node_grid
from ..solvers.structured_mg import StructuredPoissonMG
from ..timestepping import AdaptiveDriver

MU_E_EXPR = "2.3987*E_m**(-0.26)"
D_E_EXPR = "4.3628e-3*E_m**0.22"
ALPHA_EXPR = "(1.1944e6 + 4.3666e26 * E_m**(-3))*exp(-2.73e7/E_m)-340.75"


@dataclass
class StreamerConfig:
    """The JAX package's StreamerConfig fields that the restart path reads,
    with the same names and meaning. The port builds corridor meshes only,
    so `z_corridor` and `r_corridor` default to the bench's corridors. It
    discretises without stabilisation and preconditions the Poisson block
    with the structured multigrid (the JAX package's `stab_mode="off"`,
    `poisson_precond="mg-zline"`)."""

    U_w: float = 18750.0          # applied voltage [V]
    box_width: float = 0.0125     # [m] (r extent)
    box_height: float = 0.0125    # [m] (z extent)
    dt_min: float = 1e-15
    dt_max: float = 5e-12
    ttol: float = 1e-3
    mu_e_expr: str = MU_E_EXPR
    D_e_expr: str = D_E_EXPR
    alpha_expr: str = ALPHA_EXPR
    quad_degree: int = 2
    Em_floor: float = 1.0         # [V/m] guard for E_m^-3 style expressions
    dtype: object = None          # None -> float64; torch.float32 for the
                                  # fast path with float64 reductions
    mg_levels: int = 4            # the Poisson block's structured MG
    # z-corridor refinement (z0, z1, dz): uniform dz on [z0, z1], geometric
    # coarsening outside (the port builds corridor meshes only)
    z_corridor: tuple = (0.0, 1.08e-2, 1e-5)
    # fixed-topology corridor tails (n_lo, n_hi), see `_z_coords_fixed`
    z_tail_cells: Optional[tuple] = None
    # r-corridor refinement (r1, dr): uniform dr on [0, r1], geometric
    # coarsening out to box_width
    r_corridor: tuple = (2e-3, 2e-5)
    newton: NewtonConfig = None
    # after each accepted step, clamp the species log-densities at
    # ln(density_floor); None disables
    density_floor: Optional[float] = None

    def __post_init__(self):
        if self.newton is None:
            if self.dtype == torch.float32:
                self.newton = NewtonConfig(rtol=1e-3, max_iter=20,
                                           linear_tol=1e-4,
                                           linear_maxiter=400,
                                           accept_reduction=3e-2)
            else:
                self.newton = NewtonConfig(rtol=1e-4, max_iter=20,
                                           linear_tol=1e-6,
                                           linear_maxiter=800)


def _geom_tail(span: float, dz: float, n: int) -> np.ndarray:
    """`n` cell sizes dz*r^1..dz*r^n covering exactly `span`, the ratio r
    solved by bisection."""
    if not (span > 0 and n >= 1):
        raise ValueError("tail needs span > 0 and n >= 1")
    target = span / dz

    def ssum(r):
        return float(n) if abs(r - 1.0) < 1e-12 else r * (r**n - 1) / (r - 1)

    lo, hi = 1e-9, 1e3
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if ssum(mid) < target:
            lo = mid
        else:
            hi = mid
    r = 0.5 * (lo + hi)
    sizes = dz * r ** np.arange(1, n + 1)
    return sizes * (span / sizes.sum())


def _z_coords_fixed(cfg: StreamerConfig) -> np.ndarray:
    """Fixed-topology corridor z-lines: n_lo + n_fine + n_hi cells whatever
    the corridor's position."""
    z0, z1, dz = cfg.z_corridor
    n_lo, n_hi = cfg.z_tail_cells
    if not z0 > 0:
        raise ValueError("fixed-topology corridor needs z0 > 0")
    n_fine = int(round((z1 - z0) / dz))
    div = 2 ** max(cfg.mg_levels - 1, 0)
    n_fine += (-(n_lo + n_fine + n_hi)) % div
    z1 = z0 + n_fine * dz
    if not z1 < cfg.box_height:
        raise ValueError("padded corridor exceeds the domain")
    lo = (z0 - np.cumsum(_geom_tail(z0, dz, n_lo)))[::-1]
    lo[0] = 0.0
    hi = z1 + np.cumsum(_geom_tail(cfg.box_height - z1, dz, n_hi))
    hi[-1] = cfg.box_height
    return np.concatenate([lo, z0 + dz * np.arange(n_fine + 1), hi])


def _pad_to_levels(zs: np.ndarray, mg_levels: int) -> np.ndarray:
    """Split the largest intervals until the cell count divides
    2**(mg_levels-1), so the multigrid can coarsen by exact 2:1 slicing."""
    div = 2 ** max(mg_levels - 1, 0)
    while (len(zs) - 1) % div:
        i = int(np.argmax(np.diff(zs)))
        zs = np.insert(zs, i + 1, 0.5 * (zs[i] + zs[i + 1]))
    return zs


def z_coords(cfg: StreamerConfig) -> np.ndarray:
    """z-lines: uniform dz in the corridor, geometric tails outside."""
    if cfg.z_tail_cells is not None:
        return _z_coords_fixed(cfg)
    z0, z1, dz = cfg.z_corridor
    fine = np.arange(z0, z1 + 0.5 * dz, dz)
    n_lo = max(2, int(round(np.log(max(z0, dz) / dz) / np.log(1.12))))
    lo = np.geomspace(dz, max(z0, dz), n_lo)
    lo = z0 - np.cumsum(lo[::-1])[::-1] + dz  # grow away from the corridor
    lo = lo[(lo > 0) & (lo < z0 - 0.5 * dz)]
    hi_len = cfg.box_height - z1
    n_hi = max(2, int(round(np.log(max(hi_len, dz) / dz) / np.log(1.12))))
    hi = z1 + np.cumsum(np.geomspace(dz, hi_len / 3, n_hi))
    hi = hi[hi < cfg.box_height - 0.5 * dz]
    zs = np.unique(np.concatenate([[0.0], lo, fine, hi, [cfg.box_height]]))
    return _pad_to_levels(zs, cfg.mg_levels)


def r_coords(cfg: StreamerConfig) -> np.ndarray:
    """r-lines: uniform dr on [0, r1], geometric coarsening (ratio ~1.12)
    out to box_width."""
    r1, dr = cfg.r_corridor
    fine = np.arange(0.0, r1 + 0.5 * dr, dr)
    rest = cfg.box_width - fine[-1]
    n_hi = max(2, int(round(np.log(max(rest, dr) / dr) / np.log(1.12))))
    hi = fine[-1] + np.cumsum(np.geomspace(dr * 1.12, rest / 3, n_hi))
    hi = hi[hi < cfg.box_width - 0.5 * dr]
    rs = np.unique(np.concatenate([fine, hi, [cfg.box_width]]))
    return _pad_to_levels(rs, cfg.mg_levels)


def make_mesh(cfg: StreamerConfig) -> Mesh:
    """Tensor-product 'right'-split mesh on the (r, z) coordinate lines."""
    xs, zs = r_coords(cfg), z_coords(cfg)
    mesh = rectangle_mesh((0, 0), (cfg.box_width, cfg.box_height),
                          len(xs) - 1, len(zs) - 1)
    coords = mesh.coords.copy()
    coords[:, 0] = np.interp(coords[:, 0], np.unique(coords[:, 0]), xs)
    coords[:, 1] = np.interp(coords[:, 1], np.unique(coords[:, 1]), zs)
    return Mesh(coords, mesh.cells)


class StreamerModel:
    SIGN = (1.0, -1.0)  # ion, electron charge signs

    def __init__(self, cfg: StreamerConfig = None, device="cuda"):
        self.cfg = cfg = cfg or StreamerConfig()
        if cfg.mg_levels <= 1:
            raise NotImplementedError(
                "only the structured multigrid Poisson preconditioner "
                "(mg_levels > 1) is ported")
        self.device = dev = resolve_device(device)
        self.mesh = mesh = make_mesh(cfg)
        # boundary list as in `fedm-streamer.py:98-101`
        mark_boundaries(mesh, [
            ["line", 0.0, 0.0, 0.0, cfg.box_width],                       # 1
            ["line", cfg.box_height, cfg.box_height, 0.0, cfg.box_width],  # 2
            ["line", 0.0, cfg.box_height, 0.0, 0.0],                      # 3
            ["line", 0.0, cfg.box_height, cfg.box_width, cfg.box_width],  # 4
        ])
        self.space = FunctionSpace(mesh)
        self.batch = CellBatch(self.space, quad_degree=cfg.quad_degree,
                               axisymmetric=True, dtype=cfg.dtype, device=dev)
        self.n_eq = 3
        self._mu_e = compile_expression(cfg.mu_e_expr)
        self._D_e = compile_expression(cfg.D_e_expr)
        self._alpha = compile_expression(cfg.alpha_expr)

        cathode = self.space.dofs_where(lambda x: np.isclose(x[:, 1], 0.0))
        anode = self.space.dofs_where(
            lambda x: np.isclose(x[:, 1], cfg.box_height))
        bcs = BCSet(self.space, self.n_eq,
                    [DirichletBC(cathode, 2, 0.0),
                     DirichletBC(anode, 2, cfg.U_w)], device=dev)
        self.system = CoupledSystem(self.batch, self.n_eq, bcs, cfg.newton)
        self.system.set_cell_kernel(self._cell_kernel)
        # Neumann electron outflow on the electrodes (markers 1 and 2,
        # `fedm-streamer.py:103-104`); axis and outer wall are zero-flux
        fb = FacetBatch(self.space, markers=[1, 2],
                        quad_degree=cfg.quad_degree, axisymmetric=True,
                        dtype=cfg.dtype, device=dev)
        self.system.add_facet_kernel(fb, self._electrode_kernel)
        self._smg = self._structured_mg()
        self.system.enable_elliptic_precond(2, self._smg)

    def _structured_mg(self) -> StructuredPoissonMG:
        """The z-line V-cycle on the Poisson row (canonical tensor-product
        meshes only)."""
        if canonical_node_grid(self.space) is None:
            raise ValueError("the structured multigrid needs a canonical "
                             "tensor-product mesh")
        xs = np.unique(self.mesh.coords[:, 0])
        zs = np.unique(self.mesh.coords[:, 1])
        mask_grid = np.zeros((len(xs), len(zs)), bool)
        mask_grid[:, 0] = mask_grid[:, -1] = True  # cathode/anode z-lines
        return StructuredPoissonMG(xs, zs, mask_grid, self.cfg.mg_levels,
                                   dtype=self.batch.dtype, device=self.device)

    # -- kernels --------------------------------------------------------------

    def _coeffs(self, E_m):
        # the fun:E expressions are the coefficients themselves, no /N0
        # (`fedm-streamer.py:237-238`)
        return (self._mu_e(E_m=E_m), self._D_e(E_m=E_m),
                self._alpha(E_m=E_m))

    def _cell_kernel(self, cb: CellBatch, delta_e, ctx):
        p = ctx["params"]
        u_old_e, d_hist_e = ctx["u_old"], ctx["d_hist"]
        u_e = u_old_e + delta_e

        E_q = -cb.grad(u_e[..., 2])  # [c, q, dim]
        E_m = torch.sqrt(torch.sum(E_q * E_q, dim=-1)
                         + self.cfg.Em_floor**2)
        mu_q, D_q, alpha_q = self._coeffs(E_m)
        ne_q = torch.exp(cb.value(u_e[..., 1]))
        gue_q = cb.grad(u_e[..., 1])

        # impact-ionisation source (`fedm-streamer.py:244-245`)
        f_ion = alpha_q * mu_q * E_m * ne_q
        # electron flux, grad_diffusion=False (`fedm-streamer.py:242`)
        Gamma_e = (-D_q[..., None] * ne_q[..., None] * gue_q
                   + self.SIGN[1] * mu_q[..., None] * E_q * ne_q[..., None])

        contrib_i = balance_equation_contrib(
            cb, "reaction", delta_e[..., 0], u_old_e[..., 0],
            d_hist_e[..., 0], p.dt, p.dt_old, f_ion)
        contrib_e = balance_equation_contrib(
            cb, "drift-diffusion-reaction", delta_e[..., 1], u_old_e[..., 1],
            d_hist_e[..., 1], p.dt, p.dt_old, f_ion, Gamma_q=Gamma_e)
        # Poisson: stiffness(grad Phi) - mass(rho/eps0)
        rho_q = (torch.exp(cb.value(u_e[..., 0])) - ne_q) * (
            elementary_charge / epsilon_0)
        contrib_p = cb.stiffness(cb.grad(u_e[..., 2])) - cb.mass(rho_q)
        return torch.stack([contrib_i, contrib_e, contrib_p], dim=-1)

    def _electrode_kernel(self, fb: FacetBatch, delta_e, ctx):
        """Neumann electron outflow: + 2 pi r (sign mu E . n) e^u v ds
        (`fedm/functions.py:523-524`)."""
        u_e = ctx["u_old"] + delta_e
        E_q = -fb.grad(u_e[..., 2])
        E_m = torch.sqrt(torch.sum(E_q * E_q, dim=-1)
                         + self.cfg.Em_floor**2)
        mu_q = self._mu_e(E_m=E_m)
        En = torch.einsum("fqd,fd->fq", E_q, fb.normal)
        ne_q = torch.exp(fb.value(u_e[..., 1]))
        contrib_e = fb.mass(self.SIGN[1] * mu_q * En * ne_q)
        zero = torch.zeros_like(contrib_e)
        return torch.stack([zero, contrib_e, zero], dim=-1)

    # -- driver ----------------------------------------------------------------

    def floor_projection(self) -> Optional[Callable]:
        """Accepted-state projection for `AdaptiveDriver(post_accept=...)`:
        clamps all species log-densities at ln(density_floor), so no e^u
        underflows to an exactly zero (structurally singular) Jacobian
        column."""
        if self.cfg.density_floor is None:
            return None
        u_floor = float(np.log(self.cfg.density_floor))
        n_sp = self.n_eq - 1  # the last column is Phi

        def clamp(u: torch.Tensor) -> torch.Tensor:
            out = u.clone()
            out[:, :n_sp] = torch.clamp(u[:, :n_sp], min=u_floor)
            return out

        return clamp

    def make_driver(self, verbose: bool = False) -> AdaptiveDriver:
        """The adaptive driver with the configured tolerances, monitoring
        the electron density (index n_eq - 2, LFA) and applying the density
        floor to accepted states."""
        return AdaptiveDriver(
            self.system, monitor_idx=self.n_eq - 2, ttol=self.cfg.ttol,
            dt_min=self.cfg.dt_min, dt_max=self.cfg.dt_max, verbose=verbose,
            post_accept=self.floor_projection())
