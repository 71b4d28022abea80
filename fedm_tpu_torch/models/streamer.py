"""Positive streamer in air — the Bagheri et al. benchmark (Plasma Sources
Sci. Technol. 27 (2018) 095002), local field approximation:

  u[:, 0] = ln n_ion   (reaction — immobile ions)
  u[:, 1] = ln n_e     (drift-diffusion-reaction, log form)
  u[:, 2] = Phi        (Poisson)

on an axisymmetric (r, z) box, U = 18.75 kV across 1.25 cm at 760 Torr,
with closed-form transport and ionisation coefficients of the field
magnitude (`fedm-streamer.py:237-239`) evaluated at quadrature points inside
the residual.

Port of the JAX package's `models/streamer.py`: the configuration, the
graded and corridor-refined tensor-product meshes (with the fixed-topology
tails of the moving window), the cell kernel with optional upwind
stabilisation, the electrode kernel, the Poisson-row preconditioners
(`poisson_precond`: the point-smoothed geometric multigrid, the structured
z-line multigrid, single-level z-line Richardson), the transport z-line
preconditioner and row equilibration, the initial state (Gaussian ion seed
and the initial Poisson solve), the moving window (`move_window`) and state
remap, the far-field density floor, and the reference-format input reader
(`from_file_input`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
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
from ..ops.stabilization import MODES, directional_h, upwind_diffusion
from ..solvers.elliptic import solve_poisson
from ..solvers.linesmoother import ZLineSmoother
from ..solvers.multigrid import GeometricMultigrid
from ..solvers.newton import NewtonConfig
from ..solvers.stencil import canonical_node_grid
from ..solvers.structured_mg import StructuredPoissonMG
from ..timestepping import AdaptiveDriver, TimeState

MU_E_EXPR = "2.3987*E_m**(-0.26)"
D_E_EXPR = "4.3628e-3*E_m**0.22"
ALPHA_EXPR = "(1.1944e6 + 4.3666e26 * E_m**(-3))*exp(-2.73e7/E_m)-340.75"
# Poisson-row preconditioners: the point-Chebyshev-smoothed V-cycle, the
# V-cycle with z-line relaxation (anisotropic corridor meshes) and
# single-level z-line Richardson
POISSON_PRECONDS = ("mg", "mg-zline", "zline")


@dataclass
class StreamerConfig:
    """The JAX package's StreamerConfig, with the same names, defaults and
    meaning."""

    U_w: float = 18750.0          # applied voltage [V]
    p0: float = 760.0             # pressure [Torr]
    Tgas: float = 300.0
    box_width: float = 0.0125     # [m] (r extent)
    box_height: float = 0.0125    # [m] (z extent)
    nx: int = 80                  # graded cells in r (without r_corridor)
    ny: int = 160                 # graded cells in z (without z_corridor)
    grade: float = 2.5            # sinh grading toward the axis and seed
    seed_amplitude: float = 5e18  # [m^-3]
    seed_width: float = 0.4e-3    # [m]
    seed_z: float = 1e-2          # [m]
    background: float = 1e13      # [m^-3]
    dt_init: float = 5e-12
    dt_min: float = 1e-15
    dt_max: float = 5e-12
    ttol: float = 1e-3
    T_final: float = 1.4e-8
    mu_e_expr: str = MU_E_EXPR
    D_e_expr: str = D_E_EXPR
    alpha_expr: str = ALPHA_EXPR
    quad_degree: int = 2
    Em_floor: float = 1.0         # [V/m] guard for E_m^-3 style expressions
    # artificial diffusion stab*0.5*mu*|E|*h added to the electron
    # diffusion coefficient; 0 = plain Galerkin
    stab_diffusion: float = 0.0
    # upwind stabilisation (ops/stabilization.py): 'off', 'linear' or
    # 'peclet' with the directional cell size along E
    stab_mode: str = "off"
    stab_coeff: float = 1.0
    dtype: object = None          # None -> float64; torch.float32 for the
                                  # fast path with float64 reductions
    mg_levels: int = 4            # Poisson-block V-cycle levels; <= 1
                                  # disables the multigrid
    poisson_precond: str = "mg"   # one of POISSON_PRECONDS
    zline_iters: int = 2          # Richardson sweeps of 'zline'
    # per-z-line tridiagonal preconditioning of the electron transport row
    # (CoupledSystem.enable_transport_zline); tensor-product meshes only
    transport_zline: bool = False
    # z-corridor refinement (z0, z1, dz): uniform dz on [z0, z1], geometric
    # coarsening outside; None: `ny` graded cells
    z_corridor: Optional[tuple] = None
    # fixed-topology corridor tails (n_lo, n_hi): the same node count for
    # every corridor position, what the moving window needs
    z_tail_cells: Optional[tuple] = None
    # wall-clustered lower tail: its first cell at the cathode is this size
    z_wall_dz: Optional[float] = None
    # r-corridor refinement (r1, dr): uniform dr on [0, r1], geometric
    # coarsening out to box_width; None: `nx` graded cells
    r_corridor: Optional[tuple] = None
    newton: NewtonConfig = None
    # row-equilibrated Newton system (CoupledSystem.row_scaled)
    row_scaled: bool = False
    # after each accepted step, clamp the species log-densities at
    # ln(density_floor); None disables
    density_floor: Optional[float] = None

    def __post_init__(self):
        if self.stab_mode not in MODES:
            raise ValueError(f"stab_mode {self.stab_mode!r}; options are "
                             f"{MODES}")
        if self.poisson_precond not in POISSON_PRECONDS:
            raise ValueError(f"poisson_precond {self.poisson_precond!r}; "
                             f"options are {POISSON_PRECONDS}")
        if self.newton is None:
            if self.dtype == torch.float32:
                self.newton = NewtonConfig(rtol=1e-3, max_iter=20,
                                           linear_tol=1e-4,
                                           linear_maxiter=400,
                                           accept_reduction=3e-2,
                                           host_loop=True)
            else:
                self.newton = NewtonConfig(rtol=1e-4, max_iter=20,
                                           linear_tol=1e-6,
                                           linear_maxiter=800)

    @property
    def N0(self) -> float:
        return self.p0 * 3.21877e22


def _graded_coords(n: int, length: float, grade: float,
                   focus: float) -> np.ndarray:
    """Node coordinates on [0, length], sinh-refined toward `focus`
    (0: the start, 1: the end); grade <= 0 gives a uniform grid."""
    s = np.linspace(0.0, 1.0, n + 1)
    if grade <= 0:
        return s * length
    t = np.sinh(grade * (s - focus)) / grade
    t = (t - t[0]) / (t[-1] - t[0])
    return t * length


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


def _wall_tail(span: float, dz: float, dz_wall: float,
               n: int) -> np.ndarray:
    """`n` cell sizes covering exactly `span` between the wall (z = 0) and a
    corridor edge whose adjacent cell is `dz`, clustered at both ends:
    n//2 sizes dz_wall*g^0.. growing from the wall and the rest dz*g^1..
    growing from the corridor, one ratio g solved by bisection; ordered
    wall to corridor."""
    if not (span > 0 and n >= 2 and dz_wall > 0):
        raise ValueError("wall tail needs span > 0, n >= 2 and dz_wall > 0")
    n1 = n // 2
    n2 = n - n1

    def ssum(g):
        if abs(g - 1.0) < 1e-12:
            return dz_wall * n1 + dz * n2
        return (dz_wall * (g**n1 - 1) / (g - 1)
                + dz * g * (g**n2 - 1) / (g - 1))

    lo, hi = 1e-9, 1e3
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if ssum(mid) < span:
            lo = mid
        else:
            hi = mid
    g = 0.5 * (lo + hi)
    wall = dz_wall * g ** np.arange(n1)
    corr = dz * g ** np.arange(1, n2 + 1)
    sizes = np.concatenate([wall, corr[::-1]])
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
    if cfg.z_wall_dz is not None:
        lo = np.concatenate([[0.0], np.cumsum(
            _wall_tail(z0, dz, cfg.z_wall_dz, n_lo))[:-1]])
    else:
        lo = (z0 - np.cumsum(_geom_tail(z0, dz, n_lo)))[::-1]
        lo[0] = 0.0
    hi = z1 + np.cumsum(_geom_tail(cfg.box_height - z1, dz, n_hi))
    hi[-1] = cfg.box_height
    zs = np.concatenate([lo, z0 + dz * np.arange(n_fine + 1), hi])
    if not np.all(np.diff(zs) > 0):
        raise ValueError("fixed-topology z-lines are not increasing")
    return zs


def _pad_to_levels(zs: np.ndarray, mg_levels: int) -> np.ndarray:
    """Split the largest intervals until the cell count divides
    2**(mg_levels-1), so the multigrid can coarsen by exact 2:1 slicing."""
    div = 2 ** max(mg_levels - 1, 0)
    while (len(zs) - 1) % div:
        i = int(np.argmax(np.diff(zs)))
        zs = np.insert(zs, i + 1, 0.5 * (zs[i] + zs[i + 1]))
    return zs


def z_coords(cfg: StreamerConfig) -> np.ndarray:
    """z-lines: cfg.ny cells graded toward the seed without a corridor;
    else uniform dz in the corridor and geometric tails outside."""
    if cfg.z_corridor is None:
        return _graded_coords(cfg.ny, cfg.box_height, cfg.grade,
                              cfg.seed_z / cfg.box_height)
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
    """r-lines: `nx` cells graded toward the axis without a corridor; else
    uniform dr on [0, r1], geometric coarsening (ratio ~1.12) out to
    box_width."""
    if cfg.r_corridor is None:
        return _graded_coords(cfg.nx, cfg.box_width, cfg.grade, 0.0)
    r1, dr = cfg.r_corridor
    fine = np.arange(0.0, r1 + 0.5 * dr, dr)
    rest = cfg.box_width - fine[-1]
    n_hi = max(2, int(round(np.log(max(rest, dr) / dr) / np.log(1.12))))
    hi = fine[-1] + np.cumsum(np.geomspace(dr * 1.12, rest / 3, n_hi))
    hi = hi[hi < cfg.box_width - 0.5 * dr]
    rs = np.unique(np.concatenate([fine, hi, [cfg.box_width]]))
    return _pad_to_levels(rs, cfg.mg_levels)


def _mesh_on(cfg: StreamerConfig, xs: np.ndarray, zs: np.ndarray) -> Mesh:
    """Tensor-product 'right'-split mesh on the (r, z) coordinate lines,
    its boundary facets marked as in `fedm-streamer.py:98-101`: 1 the
    cathode (z = 0), 2 the anode, 3 the axis, 4 the outer wall."""
    mesh = rectangle_mesh((0, 0), (cfg.box_width, cfg.box_height),
                          len(xs) - 1, len(zs) - 1)
    coords = mesh.coords.copy()
    coords[:, 0] = np.interp(coords[:, 0], np.unique(coords[:, 0]), xs)
    coords[:, 1] = np.interp(coords[:, 1], np.unique(coords[:, 1]), zs)
    mesh = Mesh(coords, mesh.cells)
    mark_boundaries(mesh, [
        ["line", 0.0, 0.0, 0.0, cfg.box_width],
        ["line", cfg.box_height, cfg.box_height, 0.0, cfg.box_width],
        ["line", 0.0, cfg.box_height, 0.0, 0.0],
        ["line", 0.0, cfg.box_height, cfg.box_width, cfg.box_width],
    ])
    return mesh


def make_mesh(cfg: StreamerConfig) -> Mesh:
    """The configuration's mesh (the JAX package's `_make_mesh`)."""
    return _mesh_on(cfg, r_coords(cfg), z_coords(cfg))


# -- moving-window remap weights ------------------------------------------


def _tophat_avg_row(zs: np.ndarray, a: float, b: float) -> np.ndarray:
    """Nodal weights of (1/(b-a)) * integral_a^b u(z) dz for u piecewise
    linear on the z-lines `zs` (exact trapezoid over the merged grid)."""
    a, b = max(a, zs[0]), min(b, zs[-1])
    pts = np.concatenate(([a], zs[(zs > a) & (zs < b)], [b]))
    i1 = np.clip(np.searchsorted(zs, pts), 1, len(zs) - 1)
    i0 = i1 - 1
    w = (pts - zs[i0]) / (zs[i1] - zs[i0])
    seg = np.diff(pts)
    coef = np.zeros(len(pts))
    coef[:-1] += 0.5 * seg
    coef[1:] += 0.5 * seg
    row = np.zeros(len(zs))
    np.add.at(row, i0, coef * (1.0 - w))
    np.add.at(row, i1, coef * w)
    return row / (b - a)


def _z_interp_weights(zs: np.ndarray, zd: np.ndarray) -> np.ndarray:
    """[len(zd), len(zs)] z-linear interpolation matrix (identity on
    matching z-planes) — `move_window`'s remap."""
    n_d, n_s = len(zd), len(zs)
    idx1 = np.clip(np.searchsorted(zs, zd), 1, n_s - 1)
    idx0 = idx1 - 1
    w = (zd - zs[idx0]) / (zs[idx1] - zs[idx0])
    W = np.zeros((n_d, n_s))
    W[np.arange(n_d), idx0] = 1.0 - w
    # += not =: exact node hits (w = 0 or 1) must not overwrite
    np.add.at(W, (np.arange(n_d), idx1), w)
    return W


def _z_remap_weights(zs: np.ndarray, zd: np.ndarray) -> np.ndarray:
    """[len(zd), len(zs)] remap matrix: z-linear interpolation rows, except
    interior destination nodes whose local spacing exceeds 1.5x the source
    spacing there, which average the source over a symmetric top-hat of
    the local destination spacing (anti-aliasing restriction). Boundary
    nodes always interpolate."""
    n_d, n_s = len(zd), len(zs)
    W = _z_interp_weights(zs, zd)
    src_gap = np.diff(zs)
    gap_at = src_gap[np.clip(np.searchsorted(zs, zd) - 1, 0, n_s - 2)]
    for j in range(1, n_d - 1):
        h_half = 0.5 * min(zd[j] - zd[j - 1], zd[j + 1] - zd[j])
        if 2.0 * h_half > 1.5 * gap_at[j]:
            W[j] = _tophat_avg_row(zs, zd[j] - h_half, zd[j] + h_half)
    return W


class StreamerModel:
    SIGN = (1.0, -1.0)  # ion, electron charge signs

    @classmethod
    def from_file_input(cls, file_input, model: str = "benchmark_model",
                        mesh: Optional[Mesh] = None, device="cuda",
                        **config_overrides) -> "StreamerModel":
        """The model from a reference-format input tree (`speclist.cfg`,
        `transport_coefficients/*.dat` with `fun:E` expressions,
        `species/*.cfg`; `fedm-streamer.py:47-48,227-245`): the electron
        mobility and diffusion expressions and, when the tree has
        `alpha.dat`, the ionisation expression replace the built-in ones;
        the species' charge signs replace `SIGN`."""
        from ..chemistry.parsers import (read_particle_properties,
                                         read_single_string, read_speclist,
                                         read_transport_coefficients)
        from ..model.approximation import modify_approximation_vars

        n_sp, species, prop_files, _ = read_speclist(
            Path(file_input) / model)
        masses, signs = read_particle_properties(prop_files, model,
                                                 file_input=file_input)
        _, _, species, _, signs = modify_approximation_vars(
            "LFA", n_sp, species, masses, signs)
        # the streamer looks transport files up by species name
        # (`fedm-streamer.py:227-228`)
        _, mu_y, mu_dep = read_transport_coefficients(
            species, "mobility", model, file_input=file_input)
        _, D_y, D_dep = read_transport_coefficients(
            species, "Diffusion", model, file_input=file_input)
        kw = dict(config_overrides)
        if mu_dep[-1] == "fun:E":
            kw["mu_e_expr"] = mu_y[-1]
        if D_dep[-1] == "fun:E":
            kw["D_e_expr"] = D_y[-1]
        alpha_file = (Path(file_input) / model / "transport_coefficients"
                      / "alpha.dat")
        if alpha_file.is_file():
            kw["alpha_expr"] = read_single_string(alpha_file)
        obj = cls(StreamerConfig(**kw), mesh=mesh, device=device)
        obj.SIGN = tuple(signs)
        return obj

    def __init__(self, cfg: StreamerConfig = None, mesh: Optional[Mesh] = None,
                 device="cuda"):
        """`mesh`: a mesh of another model of the same box to share (the
        float64 escalation model shares the float32 one's)."""
        self.cfg = cfg = cfg or StreamerConfig()
        self.device = dev = resolve_device(device)
        self.mesh = mesh = make_mesh(cfg) if mesh is None else mesh
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
        self.system.row_scaled = cfg.row_scaled
        self.system.set_cell_kernel(self._cell_kernel)
        # Neumann electron outflow on the electrodes (markers 1 and 2,
        # `fedm-streamer.py:103-104`); axis and outer wall are zero-flux
        fb = FacetBatch(self.space, markers=[1, 2],
                        quad_degree=cfg.quad_degree, axisymmetric=True,
                        dtype=cfg.dtype, device=dev)
        self.system.add_facet_kernel(fb, self._electrode_kernel)

        if cfg.transport_zline:
            if canonical_node_grid(self.space) is None:
                raise ValueError("transport_zline needs a canonical "
                                 "tensor-product mesh")
            # electrons (eq 1); the ions are reaction-only
            self.system.enable_transport_zline((1,),
                                               self._node_grid(self.space))
        self._smg = None
        if cfg.poisson_precond == "zline":
            sm = ZLineSmoother(self.system.masked_stiffness_op(2),
                               self._node_grid(self.space),
                               self.space.n_dofs,
                               n_iter=cfg.zline_iters, dtype=cfg.dtype,
                               device=dev)
            self.system.enable_elliptic_precond(2, solver=sm.solve)
        elif cfg.mg_levels > 1 and not self._try_structured_mg():
            mg = self._geometric_mg()
            if mg is not None:
                self.system.enable_elliptic_precond(2, mg=mg)

    @staticmethod
    def _node_grid(space) -> np.ndarray:
        """[n_r, n_z] dof-id grid of a tensor-product mesh's space (id =
        iz * n_r + ir): the z-lines of line relaxation."""
        nxv = len(np.unique(space.mesh.coords[:, 0]))
        nzv = space.n_dofs // nxv
        if nxv * nzv != space.n_dofs:
            raise ValueError("the mesh is not a tensor-product grid")
        ix, iz = np.meshgrid(np.arange(nxv), np.arange(nzv), indexing="ij")
        return iz * nxv + ix

    def _try_structured_mg(self) -> bool:
        """Install the structured z-line V-cycle (`StructuredPoissonMG`,
        geometry updated in place by `move_window`) when 'mg-zline' is
        asked on a canonical tensor-product mesh whose cell counts give at
        least two levels; returns whether it did."""
        if (self.cfg.poisson_precond != "mg-zline"
                or canonical_node_grid(self.space) is None):
            return False
        xs = np.unique(self.mesh.coords[:, 0])
        zs = np.unique(self.mesh.coords[:, 1])
        mask_grid = np.zeros((len(xs), len(zs)), bool)
        mask_grid[:, 0] = mask_grid[:, -1] = True  # cathode/anode z-lines
        try:
            smg = StructuredPoissonMG(xs, zs, mask_grid, self.cfg.mg_levels,
                                      dtype=self.batch.dtype,
                                      device=self.device)
        except ValueError:
            return False
        self.system.enable_elliptic_precond(2, mg=smg)
        self._smg = smg
        return True

    def _geometric_mg(self) -> Optional[GeometricMultigrid]:
        """The V-cycle over nested meshes made by 2:1 slicing of the
        coordinate lines (stencil levels, separable transfers), with point
        Chebyshev smoothing or, for 'mg-zline', z-line relaxation; None
        when the mesh does not coarsen to two levels."""
        cfg = self.cfg
        spaces = [self.space]
        xs = np.unique(self.mesh.coords[:, 0])
        zs = np.unique(self.mesh.coords[:, 1])
        for _ in range(1, cfg.mg_levels):
            if (len(xs) - 1) % 2 or (len(zs) - 1) % 2:
                break
            if (len(xs) - 1) // 2 < 4 or (len(zs) - 1) // 2 < 4:
                break
            xs, zs = xs[::2], zs[::2]
            m = rectangle_mesh((0, 0), (cfg.box_width, cfg.box_height),
                               len(xs) - 1, len(zs) - 1)
            coords = m.coords.copy()
            coords[:, 0] = np.interp(coords[:, 0], np.unique(coords[:, 0]),
                                     xs)
            coords[:, 1] = np.interp(coords[:, 1], np.unique(coords[:, 1]),
                                     zs)
            spaces.append(FunctionSpace(Mesh(coords, m.cells)))
        if len(spaces) < 2:
            return None
        masks = [np.isclose(sp.dof_coords[:, 1], 0.0)
                 | np.isclose(sp.dof_coords[:, 1], cfg.box_height)
                 for sp in spaces]
        line_grids = ([self._node_grid(sp) for sp in spaces]
                      if cfg.poisson_precond == "mg-zline" else None)
        return GeometricMultigrid(spaces, masks, axisymmetric=True,
                                  quad_degree=cfg.quad_degree,
                                  dtype=cfg.dtype, line_grids=line_grids,
                                  device=self.device)

    # -- moving window --------------------------------------------------------

    def move_window(self, new_corridor: tuple, state: TimeState = None):
        """Re-centre the fine z-corridor: rebuild every coordinate-derived
        table (cell and facet quadrature tables, the multigrid's stencils,
        transfers and coarse inverse) for the new window position, with the
        same topology and shapes, and swap them into the running system.
        The driver and its state survive. Refused when the Poisson row's
        preconditioner is installed but is not the structured multigrid:
        its geometry would go stale.

        Returns `state` remapped z-linearly per r-line onto the new nodes
        (see `_remap_z`), or None when no state is given."""
        cfg = self.cfg
        if cfg.z_tail_cells is None:
            raise ValueError("move_window needs the fixed-topology z-lines "
                             "(StreamerConfig.z_tail_cells)")
        if self._smg is None and self.system._ell is not None:
            raise RuntimeError(
                "move_window would keep a stale Poisson preconditioner: it "
                "is not the structured multigrid, whose geometry the move "
                "updates (that needs poisson_precond='mg-zline' and cell "
                "counts divisible by 2**(mg_levels-1) in r and z)")
        zs_old = np.unique(self.mesh.coords[:, 1])
        xs = np.unique(self.mesh.coords[:, 0])
        new_cfg = dataclasses.replace(cfg, z_corridor=tuple(new_corridor))
        # on z-slabs the remap reads whole z-lines: gather the state, remap
        # it as on one card and keep this rank's rows
        place = getattr(self.system, "place_state", None)
        if state is not None and place is not None:
            whole = self.system.gather_state
            state = dataclasses.replace(state, u=whole(state.u),
                                        u_old=whole(state.u_old),
                                        u_old1=whole(state.u_old1))
        zs_new = z_coords(new_cfg)
        if len(zs_new) != len(zs_old):
            raise ValueError("the window moved to another node count; the "
                             "corridor's span must stay the same")
        mesh = _mesh_on(cfg, xs, zs_new)
        space = FunctionSpace(mesh)
        batch = CellBatch(space, quad_degree=cfg.quad_degree,
                          axisymmetric=True, dtype=cfg.dtype,
                          device=self.device)
        fb = FacetBatch(space, markers=[1, 2], quad_degree=cfg.quad_degree,
                        axisymmetric=True, dtype=cfg.dtype,
                        device=self.device)
        self.system.update_geometry([batch, fb])
        if self._smg is not None:
            self._smg.update_geometry(xs, zs_new)
        # self.batch is the system's cell batch, updated in place
        self.mesh, self.space, self.cfg = mesh, space, new_cfg
        if state is None:
            return None
        state = self._remap_z(state, zs_old, zs_new, len(xs))
        if place is None:
            return state
        return dataclasses.replace(state, u=place(state.u),
                                   u_old=place(state.u_old),
                                   u_old1=place(state.u_old1))

    def remap_state(self, dst_model: "StreamerModel", state: TimeState,
                    restrict: bool = True) -> TimeState:
        """`state` interpolated onto another StreamerModel's mesh, which
        must share this mesh's r-lines: every column z-linearly per r-line
        (linear in u = ln n, so a geometric mean of densities). History and
        controller state carry over. `restrict` (a cross-resolution resume)
        averages locally coarser destination nodes over a top-hat instead
        of sampling them (see `_z_remap_weights`)."""
        src_c, dst_c = self.space.dof_coords, dst_model.space.dof_coords
        rs, rd = np.unique(src_c[:, 0]), np.unique(dst_c[:, 0])
        if not (len(rs) == len(rd) and np.allclose(rs, rd)):
            raise ValueError("remap_state needs identical radial node lines")
        return self._remap_z(state, np.unique(src_c[:, 1]),
                             np.unique(dst_c[:, 1]), len(rs),
                             restrict=restrict)

    def _remap_z(self, state: TimeState, zs: np.ndarray, zd: np.ndarray,
                 n_r: int, restrict: bool = False) -> TimeState:
        """Per-r-line z remap of u, u_old and u_old1 from the z-lines `zs`
        onto `zd`: z-linear interpolation, or with `restrict` the
        anti-aliasing weights of `_z_remap_weights`. W @ U runs in float64
        on the state's device."""
        W_np = (_z_remap_weights(zs, zd) if restrict
                else _z_interp_weights(zs, zd))
        W = torch.as_tensor(W_np, dtype=torch.float64, device=state.u.device)
        n_eq = self.n_eq

        def remap(u):
            # node id = iz * n_r + ir (mesh/generators.py layout)
            V = W @ u.reshape(len(zs), n_r * n_eq)
            return V.reshape(len(zd) * n_r, n_eq)

        return dataclasses.replace(state, u=remap(state.u),
                                   u_old=remap(state.u_old),
                                   u_old1=remap(state.u_old1))

    # -- kernels --------------------------------------------------------------

    def _coeffs(self, E_m):
        # the fun:E expressions are the coefficients themselves, no /N0
        # (`fedm-streamer.py:237-238`)
        return (self._mu_e(E_m=E_m), self._D_e(E_m=E_m),
                self._alpha(E_m=E_m))

    def _cell_kernel(self, cb: CellBatch, delta_e, ctx):
        cfg = self.cfg
        p = ctx["params"]
        u_old_e, d_hist_e = ctx["u_old"], ctx["d_hist"]
        u_e = u_old_e + delta_e

        E_q = -cb.grad(u_e[..., 2])  # [c, q, dim]
        E_m = torch.sqrt(torch.sum(E_q * E_q, dim=-1) + cfg.Em_floor**2)
        mu_q, D_q, alpha_q = self._coeffs(E_m)
        ne_q = torch.exp(cb.value(u_e[..., 1]))
        gue_q = cb.grad(u_e[..., 1])
        if cfg.stab_diffusion:
            D_q = D_q + (cfg.stab_diffusion * 0.5
                         * mu_q * E_m * cb.h[:, None])
        if cfg.stab_mode != "off":
            h_v = directional_h(E_q, E_m, cb.h_dir)
            D_q = upwind_diffusion(D_q, mu_q * E_m, h_v, cfg.stab_mode,
                                   cfg.stab_coeff)

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

    # -- initial state --------------------------------------------------------

    def distribute(self, devices, group=None):
        """Swap the system for a DOF-partitioned `DistributedSystem` over
        `devices` (N parts; `parallel.dd`), on the ranks of `group` when
        given (`parallel.ranks`). Call before `initial_state()`, which then
        gives the state in the distributed layout (this rank's rows); its
        Poisson solve, on the whole mesh in every rank, keeps the inner
        system's preconditioner."""
        from ..parallel.dd import DistributedSystem

        self.system = DistributedSystem(self.system, devices, group)
        return self.system

    def initial_state(self) -> TimeState:
        """Gaussian ion seed and uniform electrons
        (`fedm-streamer.py:169-172`) and the initial Poisson solve for Phi
        (`fedm-streamer.py:205-215`), preconditioned by the Poisson row's
        preconditioner (Jacobi without one): plain Jacobi-CG exhausts
        `maxiter` on anisotropic corridor meshes. Raises RuntimeError when the solve misses its
        tolerance (1e-12 in float64, 1e-6 in float32) by more than 100x
        (at least 1e-5). The state is float64 whatever the compute dtype;
        the solve's (relres, iterations) stay in `initial_poisson`."""
        cfg = self.cfg
        dev, f64 = self.device, torch.float64
        coords = self.space.dof_coords
        # on z-slabs (`CoupledSystem.use_gspmd`) this rank's node rows, its
        # slab of the cells, and the solve reduces over the slabs
        sl = getattr(self.system, "slabs", None)
        batch = self.batch
        if sl is not None:
            coords = sl.own(coords)
            batch = self.system.slab_batches[0][0]
        fill = (lambda x: x) if sl is None else sl.fill
        r, z = coords[:, 0], coords[:, 1]
        n_ion = cfg.background + cfg.seed_amplitude * np.exp(
            -(r**2 + (z - cfg.seed_z) ** 2) / cfg.seed_width**2)
        u_ion = torch.as_tensor(np.log(n_ion), dtype=f64, device=dev)
        u_el = torch.full((len(coords),), float(np.log(cfg.background)),
                          dtype=f64, device=dev)
        # float64 arithmetic on the compute dtype's tables and constant,
        # as the JAX package's promotion of its mixed-type einsums
        b64 = batch.astype(f64)
        q = torch.tensor(elementary_charge / epsilon_0,
                         dtype=self.batch.dtype, device=dev)
        rho_q = (torch.exp(b64.value(b64.gather(fill(u_ion))))
                 - torch.exp(b64.value(b64.gather(fill(u_el))))) * q
        cathode = np.isclose(z, 0.0)
        anode = np.isclose(z, cfg.box_height)
        g = np.where(anode, cfg.U_w, 0.0)
        tol = 1e-12 if self.batch.dtype == f64 else 1e-6
        ell = getattr(self.system, "inner", self.system)._ell
        phi, relres, iters = solve_poisson(
            batch, rho_q, torch.as_tensor(cathode | anode, device=dev),
            torch.as_tensor(g, dtype=self.batch.dtype, device=dev),
            tol=tol, maxiter=4000,
            precond=None if ell is None else ell[1], slabs=sl)
        relres = float(relres)
        self.initial_poisson = (relres, iters)
        if not relres < max(tol * 100, 1e-5):
            raise RuntimeError(f"initial Poisson solve did not converge "
                               f"(relres={relres:.2e})")
        u = torch.stack([u_ion, u_el, phi.to(f64)], dim=-1)
        to_dist = getattr(self.system, "to_dist", None)
        if to_dist is not None:
            u = to_dist(u)
        return TimeState(u=u, u_old=u, u_old1=u, t=0.0, dt=cfg.dt_init,
                         dt_old=1e30)

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

    def make_driver(self, error_log: Optional[Path] = None,
                    verbose: bool = False, **kw) -> AdaptiveDriver:
        """The adaptive driver with the configured tolerances, monitoring
        the electron density (index n_eq - 2, LFA) and applying the density
        floor to accepted states; `kw` are further AdaptiveDriver options."""
        return AdaptiveDriver(
            self.system, monitor_idx=self.n_eq - 2, ttol=self.cfg.ttol,
            dt_min=self.cfg.dt_min, dt_max=self.cfg.dt_max,
            error_log=error_log, verbose=verbose,
            post_accept=self.floor_projection(), **kw)

    def run(self, T_final: Optional[float] = None,
            error_log: Optional[Path] = None, verbose: bool = False,
            max_steps: int = 100000) -> TimeState:
        """From the initial state to T_final (default cfg.T_final), each
        attempted step clamped to the horizon so the run lands on it."""
        T = T_final if T_final is not None else self.cfg.T_final
        driver = self.make_driver(error_log, verbose)
        state = self.initial_state()
        while state.t < T * (1 - 1e-12) and state.n_accepted < max_steps:
            state.dt = min(state.dt, T - state.t)
            state = driver.advance(state, {})
        return state
