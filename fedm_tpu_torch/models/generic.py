"""Generic N-species coupled plasma model (LMEA) generated from a parsed
chemistry tree (the JAX package's `models/generic.py`): the discretised
equations come from a loop over the species list, as the reference FEDM's
glow script builds its weak forms (`fedm-gd.py:344-385`) — per species a
flux chosen by its equation type, a log-form balance equation and its
electrode 'flux source' terms, plus one electron-energy equation
(5/3-scaled electron transport) and one Poisson equation.

State per node (LMEA):

  u[:, 0]            = ln w_e    electron energy density (log)
  u[:, i]            = ln n_i    species i = 1 .. n_species-1 (species 0 is
                                 the background gas, held at N0)
  u[:, n_eq-1]       = Phi       Poisson

The coefficients (reduced field, k, mu, D and their energy derivatives)
are evaluated once per advance at the last accepted state (`_update_aux`)
and reach the kernels through the driver's `aux`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..chemistry import (RateCoefficients, TransportCoefficients,
                         rate_coefficient_file_names, reaction_matrices,
                         read_energy_loss, read_particle_properties,
                         read_speclist)
from ..chemistry.sources import energy_source_factors, reaction_rates
from ..constants import elementary_charge, epsilon_0, kB, me, pi
from ..fem import BCSet, CellBatch, DirichletBC, FacetBatch, FunctionSpace
from ..fem.assembly import project
from ..mesh import mark_boundaries, rectangle_mesh
from ..model.forms import Max, abs_, balance_equation_contrib
from ..model.qfield import QField
from ..model.system import CoupledSystem, StepParams
from ..solvers.elliptic import solve_poisson
from ..solvers.multigrid import GeometricMultigrid
from ..solvers.newton import NewtonConfig
from ..timestepping import AdaptiveDriver, TimeState


@dataclass
class PlasmaConfig:
    """Configuration of a generic LMEA plasma model (the JAX package's
    defaults). The per-species tuples mirror the reference script's
    hand-declared lists; None derives them from the parsed chemistry
    (charge sign and position in the species list)."""

    model: str = "argon_synth"
    # the directory holding <model>/ (required: the port has no global
    # file registry; `argon_synth.generate_argon_input` writes one)
    file_input: Optional[Path] = None
    Tgas: float = 300.0
    p0: float = 1.0                    # [Torr]
    U_w: float = -250.0                # powered-electrode voltage [V]
    gap_length: float = 0.01           # [m] (z extent)
    wall: float = 0.01                 # [m] (r extent)
    nx: int = 100
    ny: int = 100
    n_ic_species: float = 1e12         # default initial density [m^-3]
    mean_energy_init: float = 3.0      # [eV]
    we_metallic: float = 5.0           # mean secondary-electron energy [eV]
    gamma_metallic: float = 0.06
    # per-species reflection coefficients at the metallic electrodes;
    # None -> 0.3 everywhere except 5e-4 for ions
    ref_metallic: Optional[tuple] = None
    semi_implicit: bool = True
    dt_init: float = 1e-13
    dt_min: float = 1e-15
    dt_max: float = 1e-8
    ttol: float = 5e-4
    T_final: float = 5e-5
    quad_degree: int = 4
    project_lumped: bool = False
    mg_levels: int = 4    # Poisson-block multigrid (<= 1 disables)
    dtype: object = None  # None -> float64; torch.float32 for the fast path
    newton: NewtonConfig = None
    # 'reaction' | 'diffusion-reaction' | 'drift-diffusion-reaction'
    equation_types: Optional[tuple] = None
    # 'Heavy' | 'electrons'  (boundary-condition dispatch)
    particle_types: Optional[tuple] = None
    # 'Neutral' | 'Ion' | 'electrons'  (secondary-emission source)
    species_types: Optional[tuple] = None
    # initial number densities [m^-3] per species (gas entry ignored: N0)
    n_ic: Optional[tuple] = None

    def __post_init__(self):
        if self.newton is None:
            if self.dtype == torch.float32:
                # rtol 5e-3: 1e-3 sits below the float32 assembly noise
                # floor once dt grows past ~5e-11 on the 4_particles
                # chemistry
                self.newton = NewtonConfig(rtol=5e-3, max_iter=20,
                                           linear_tol=1e-4,
                                           linear_maxiter=600)
            else:
                self.newton = NewtonConfig(rtol=1e-4, max_iter=20,
                                           linear_tol=1e-6,
                                           linear_maxiter=1500)

    @property
    def N0(self) -> float:
        return self.p0 * 3.21877e22


class PlasmaModel:
    """LMEA coupled model generated from a parsed chemistry tree: energy +
    one balance equation per non-gas species + Poisson, solved
    monolithically on a "crossed" rectangle mesh, on `device`."""

    def __init__(self, cfg: PlasmaConfig = None, device="cuda"):
        self.cfg = cfg = cfg or PlasmaConfig()
        if cfg.file_input is None:
            raise ValueError("PlasmaConfig.file_input is required (e.g. a "
                             "tree written by models.argon_synth."
                             "generate_argon_input)")
        self.device = dev = resolve_device(device)
        path = Path(cfg.file_input) / cfg.model

        # -- chemistry front end (`fedm-gd.py:55-89`) -----------------------
        (self.n_species, self.species, prop_files,
         tc_names) = read_speclist(path)
        self.masses, self.signs = read_particle_properties(
            prop_files, cfg.model, file_input=cfg.file_input)
        self.P_mat, self.L_mat, self.G_mat = reaction_matrices(
            path, self.species)
        self.u_loss = read_energy_loss(path)
        # P and G - L on the device once, in each compute type, so the
        # kernels copy nothing from the host
        self._reaction_mats = {
            dt: (torch.as_tensor(self.P_mat, dtype=dt, device=dev),
                 torch.as_tensor(self.G_mat - self.L_mat, dtype=dt,
                                 device=dev))
            for dt in (torch.float32, torch.float64)}
        self.rate = RateCoefficients.read(rate_coefficient_file_names(path))
        self.mob = TransportCoefficients.read(
            tc_names, "mobility", cfg.model, file_input=cfg.file_input)
        self.dif = TransportCoefficients.read(
            tc_names, "Diffusion", cfg.model, file_input=cfg.file_input)
        # derivative tables for the semi-implicit treatment: every
        # Umean-dependent coefficient gets one
        self.rate_diff, self.mob_diff, self.dif_diff = (
            [c.table_gradient() if c.dependence == "Umean" else None
             for c in coeffs] for coeffs in (self.rate, self.mob, self.dif))

        self._derive_species_meta()
        ns = self.n_species
        self.ie = ns - 1                # electron species index
        self.n_eq = ns + 1              # LMEA: energy + species[1:] + Phi

        # heavy-particle thermal velocities (`fedm-gd.py:218-223`)
        self.vth_heavy = [0.0] * ns
        for i in range(1, ns - 1):
            self.vth_heavy[i] = float(
                np.sqrt(8.0 * kB * cfg.Tgas / (pi * self.masses[i])))

        # -- mesh / space (`fedm-gd.py:157-183`) ----------------------------
        mesh = rectangle_mesh((0, 0), (cfg.wall, cfg.gap_length),
                              cfg.nx, cfg.ny, "crossed")
        mark_boundaries(mesh, [
            ["line", 0.0, 0.0, 0.0, cfg.wall],                       # 1 z=0
            ["line", cfg.gap_length, cfg.gap_length, 0.0, cfg.wall],  # 2
            ["line", 0.0, cfg.gap_length, 0.0, 0.0],                 # 3 axis
            ["line", 0.0, cfg.gap_length, cfg.wall, cfg.wall],       # 4 wall
        ])
        self.mesh = mesh
        self.space = FunctionSpace(mesh)
        self.batch = CellBatch(self.space, quad_degree=cfg.quad_degree,
                               axisymmetric=True, dtype=cfg.dtype, device=dev)

        powered = self.space.dofs_where(lambda x: np.isclose(x[:, 1], 0.0))
        grounded = self.space.dofs_where(
            lambda x: np.isclose(x[:, 1], cfg.gap_length))
        U0 = cfg.U_w

        def phi_ramp(t):
            return U0 * (1.0 - math.exp(-t / 1e-9))

        bcs = BCSet(self.space, self.n_eq, [
            DirichletBC(powered, self.n_eq - 1, phi_ramp),
            DirichletBC(grounded, self.n_eq - 1, 0.0)], device=dev)

        self.system = CoupledSystem(self.batch, self.n_eq, bcs, cfg.newton)
        self.system.set_cell_kernel(self._cell_kernel)
        # only the metallic electrodes (markers 1, 2) carry non-zero flux
        # terms: ref=1 on axis/wall zeroes everything
        fb = FacetBatch(self.space, markers=[1, 2],
                        quad_degree=cfg.quad_degree, axisymmetric=True,
                        dtype=cfg.dtype, device=dev)
        self.system.add_facet_kernel(fb, self._electrode_kernel)

        self.mg = None
        if cfg.mg_levels > 1:
            spaces = [self.space]
            nx, ny = cfg.nx, cfg.ny
            for _ in range(cfg.mg_levels - 1):
                if nx // 2 < 4 or ny // 2 < 4:
                    break
                nx //= 2
                ny //= 2
                spaces.append(FunctionSpace(rectangle_mesh(
                    (0, 0), (cfg.wall, cfg.gap_length), nx, ny, "crossed")))
            masks = [np.isclose(sp.dof_coords[:, 1], 0.0)
                     | np.isclose(sp.dof_coords[:, 1], cfg.gap_length)
                     for sp in spaces]
            if len(spaces) >= 2:
                self.mg = GeometricMultigrid(
                    spaces, masks, axisymmetric=True, quad_degree=2,
                    dtype=self.batch.dtype, device=dev)
                self.system.enable_elliptic_precond(self.n_eq - 1, mg=self.mg)

    # -- domain decomposition ------------------------------------------------

    _dist = None

    def distribute(self, devices, group=None):
        """Swap the system for a DOF-partitioned `DistributedSystem` over
        `devices` (N parts; `parallel.dd`), on the ranks of `group` when
        given (`parallel.ranks`: this process's parts are its rank's).
        Call before `initial_state()`, which then gives the state in the
        distributed layout (this rank's rows). The per-advance coefficient
        update gathers the state back to the original numbering (an
        all-gather over the group) and scatters its fields to the
        distributed layout (once per advance, beside the halo-exchanged
        inner loops)."""
        from ..parallel.dd import DistributedSystem

        self._dist = DistributedSystem(self.system, devices, group)
        self.system = self._dist
        base_update = self._update_aux

        def update_dist(u_dist):
            return self._dist.scatter_aux(
                base_update(self._dist.gather_global(u_dist)))

        self._update_aux = update_dist
        return self._dist

    # -- per-species metadata -----------------------------------------------

    def _derive_species_meta(self):
        """Fill the per-species metadata lists, preferring configured
        values. Defaults: gas -> 'reaction'/'Heavy'/'Neutral'; charged heavy
        -> drift-diffusion 'Ion'; neutral non-gas -> diffusion-reaction
        'Neutral'; the last species is the electrons."""
        cfg, ns = self.cfg, self.n_species
        eq, pt, st = [], [], []
        for i in range(ns):
            if i == 0:
                eq.append("reaction")
                pt.append("Heavy")
                st.append("Neutral")
            elif i == ns - 1:
                eq.append("drift-diffusion-reaction")
                pt.append("electrons")
                st.append("electrons")
            elif self.signs[i] != 0:
                eq.append("drift-diffusion-reaction")
                pt.append("Heavy")
                st.append("Ion")
            else:
                eq.append("diffusion-reaction")
                pt.append("Heavy")
                st.append("Neutral")
        self.equation_types = list(cfg.equation_types or eq)
        self.particle_types = list(cfg.particle_types or pt)
        self.species_types = list(cfg.species_types or st)
        # grad inside the diffusion term for electrons only
        self.grad_diffusion = [t == "electrons" for t in self.species_types]
        if cfg.ref_metallic is not None:
            self.ref_coeffs = list(cfg.ref_metallic)
        else:
            self.ref_coeffs = [
                5e-4 if self.species_types[i] == "Ion" else 0.3
                for i in range(ns)]
        self.n_ic = list(cfg.n_ic or [cfg.n_ic_species] * ns)
        for name, lst in (("equation_types", self.equation_types),
                          ("particle_types", self.particle_types),
                          ("species_types", self.species_types),
                          ("ref_metallic", self.ref_coeffs),
                          ("n_ic", self.n_ic)):
            if len(lst) != ns:
                raise ValueError(
                    f"{name} has {len(lst)} entries for {ns} species")

    # -- per-advance coefficient update (`fedm-gd.py:429-443`) ----------------

    @torch.no_grad()
    def _update_aux(self, u: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The coefficients at the float64 state `u`: the mean energy in
        float64, the reduced field projected in the batch's type (the CG of
        `project`), the tables interpolated in float64."""
        cfg, ie = self.cfg, self.ie
        we, u_el, phi = u[:, 0], u[:, ie], u[:, self.n_eq - 1]
        eps_old = torch.exp(we - u_el)  # mean energy at the last step
        phi = phi.to(self.batch.dtype)
        gphi = self.batch.grad(self.batch.gather(phi))
        Em_q = torch.sqrt(torch.sum(gphi * gphi, dim=-1))
        redE = project(Em_q * (1e21 / cfg.N0), self.batch,
                       lumped=cfg.project_lumped)

        kw = dict(N0=cfg.N0, Tgas=cfg.Tgas, energy=eps_old, redfield=redE,
                  like=eps_old)
        mu = [c.evaluate(**kw) for c in self.mob]
        # diffusion may need the mobility (ESR): per-species mu
        D = [c.evaluate(mu=mu[i], **kw) for i, c in enumerate(self.dif)]
        k = [c.evaluate(**kw) for c in self.rate]
        zeros = torch.zeros_like(eps_old)

        def diffs(tables):
            return [c.evaluate(**kw) if c is not None else zeros
                    for c in tables]

        return {"mean_energy_old": eps_old, "redE": redE,
                "k": torch.stack(k, dim=-1),
                "k_diff": torch.stack(diffs(self.rate_diff), dim=-1),
                "mu": torch.stack(mu, dim=-1),
                "D": torch.stack(D, dim=-1),
                "mu_diff": torch.stack(diffs(self.mob_diff), dim=-1),
                "D_diff": torch.stack(diffs(self.dif_diff), dim=-1)}

    # -- shared kernel pieces ---------------------------------------------

    def _fields(self, b, delta_e, ctx):
        """Quadrature-point fields shared by the cell and facet kernels:
        per-species log-densities, semi-implicit transport coefficients and
        fluxes (the loop body of `fedm-gd.py:347-354`)."""
        cfg, ns, ie = self.cfg, self.n_species, self.ie
        u_e = ctx["u_old"] + delta_e  # absolute state (increment form)
        w = QField.from_nodal(b, u_e[..., 0])
        uQ = [None] + [QField.from_nodal(b, u_e[..., i])
                       for i in range(1, ns)]
        E_q = -b.grad(u_e[..., self.n_eq - 1])

        eps_old = QField.from_nodal(b, ctx["mean_energy_old"])
        ne_old = QField.from_nodal(b, ctx["u_old"][..., ie]).exp()
        # eps_lin: mean-energy linearisation (`fedm-gd.py:215`)
        eps_lin = eps_old + (w.exp() - uQ[ie].exp() * eps_old) / ne_old
        d_eps = eps_lin - eps_old

        # semi-implicit transport coefficients: QFields, so the flux can
        # take grad(D n) where the species needs it
        mu_si, D_si, Gamma = [None], [None], [None]
        for i in range(1, ns):
            mu_i = QField.from_nodal(b, ctx["mu"][..., i])
            if cfg.semi_implicit and self.mob_diff[i] is not None:
                mu_i = mu_i + QField.from_nodal(b, ctx["mu_diff"][..., i]) \
                    * d_eps
            D_i = QField.from_nodal(b, ctx["D"][..., i])
            if cfg.semi_implicit and self.dif_diff[i] is not None:
                D_i = D_i + QField.from_nodal(b, ctx["D_diff"][..., i]) \
                    * d_eps
            mu_si.append(mu_i)
            D_si.append(D_i)
            if self.equation_types[i] != "drift-diffusion-reaction":
                Gamma.append(None)
                continue
            n_i = uQ[i].exp()
            drift = (self.signs[i] * mu_i.val[..., None] * E_q
                     * n_i.val[..., None])
            if self.grad_diffusion[i]:
                # -grad(D n): the electron convention (`fedm-gd.py:63`)
                Gamma.append(-(D_i * n_i).grad + drift)
            else:
                # -D grad(n): heavy species
                Gamma.append(-D_i.val[..., None] * n_i.grad + drift)

        # electron energy flux with 5/3-scaled coefficients
        Pen = D_si[ie] * (5.0 / 3.0) * w.exp()
        Gamma_en = (-Pen.grad
                    + self.signs[ie] * (5.0 / 3.0) * mu_si[ie].val[..., None]
                    * E_q * w.exp().val[..., None])
        return dict(w=w, uQ=uQ, E_q=E_q, eps_old=eps_old, eps_lin=eps_lin,
                    d_eps=d_eps, mu_si=mu_si, D_si=D_si, Gamma=Gamma,
                    Gamma_en=Gamma_en)

    def _rates_and_sources(self, b, F, ctx):
        """Reaction rates with the semi-implicit k, species and energy
        sources (`Source_term`/`Energy_Source_term` of the reference)."""
        cfg, ns, ie = self.cfg, self.n_species, self.ie
        k_si = b.value(ctx["k"])        # [*, n_q, n_r]
        if cfg.semi_implicit:
            k_si = k_si + b.value(ctx["k_diff"]) * F["d_eps"].val[..., None]
        # [N0, exp(u[1:-1])]: the gas held at N0
        ln_n = torch.stack(
            [torch.full_like(F["w"].val, math.log(cfg.N0))]
            + [F["uQ"][i].val for i in range(1, ns)], dim=-1)
        P, GL = self._reaction_mats[ln_n.dtype]
        rates = reaction_rates(k_si, P, ln_n)
        f_sp = rates @ GL  # [*, n_q, n_species]
        factors = energy_source_factors(self.u_loss, F["eps_lin"].val)
        f_en = -torch.sum(rates * factors, dim=-1)
        # Joule heating -Gamma_e . E (`fedm-gd.py:359`)
        f_en = f_en - torch.sum(F["Gamma"][ie] * F["E_q"], dim=-1)
        return f_sp, f_en

    # -- cell kernel --------------------------------------------------------

    def _cell_kernel(self, cb: CellBatch, delta_e, ctx):
        p: StepParams = ctx["params"]
        ns = self.n_species
        F = self._fields(cb, delta_e, ctx)
        f_sp, f_en = self._rates_and_sources(cb, F, ctx)
        uo, dh = ctx["u_old"], ctx["d_hist"]

        # energy equation in slot 0 (LMEA; `fedm-gd.py:377`)
        contribs = [balance_equation_contrib(
            cb, "drift-diffusion-reaction", delta_e[..., 0], uo[..., 0],
            dh[..., 0], p.dt, p.dt_old, f_en, Gamma_q=F["Gamma_en"])]
        # one balance equation per non-gas species (`fedm-gd.py:362-364`)
        for i in range(1, ns):
            eq = self.equation_types[i]
            kw = {}
            if eq == "drift-diffusion-reaction":
                kw["Gamma_q"] = F["Gamma"][i]
            elif eq == "diffusion-reaction":
                kw["D_e"] = ctx["D"][..., i]
            contribs.append(balance_equation_contrib(
                cb, eq, delta_e[..., i], uo[..., i], dh[..., i],
                p.dt, p.dt_old, f_sp[..., i], **kw))

        # Poisson: stiffness(grad Phi) - mass(rho/eps0) with
        # rho = sum_i sign_i e n_i (`fedm-gd.py:255-257`)
        rho_q = 0.0
        for i in range(1, ns):
            if self.signs[i]:
                rho_q = rho_q + self.signs[i] * F["uQ"][i].exp().val
        rho_q = rho_q * (elementary_charge / epsilon_0)
        contribs.append(
            cb.stiffness(cb.grad(uo[..., self.n_eq - 1]
                                 + delta_e[..., self.n_eq - 1]))
            - cb.mass(rho_q))
        return torch.stack(contribs, dim=-1)

    # -- electrode boundary kernel ------------------------------------------

    def _electrode_kernel(self, fb: FacetBatch, delta_e, ctx):
        """'flux source' terms on the metallic electrodes, looped over the
        species list (`fedm-gd.py:366-374`)."""
        cfg, ns, ie = self.cfg, self.n_species, self.ie
        F = self._fields(fb, delta_e, ctx)
        n = fb.normal
        En = torch.einsum("fqd,fd->fq", F["E_q"], n)

        # secondary-emission source: the positive part of the summed ion
        # outflux (`fedm-gd.py:350-352`)
        Ion_flux = 0.0
        for i in range(1, ns):
            if self.species_types[i] == "Ion" and F["Gamma"][i] is not None:
                Gin = torch.einsum("fqd,fd->fq", F["Gamma"][i], n)
                Ion_flux = Ion_flux + Max(Gin, 0.0)

        gamma = cfg.gamma_metallic
        fr = [(1.0 - r) / (1.0 + r) for r in self.ref_coeffs]

        # electron thermal velocity from the last accepted mean energy
        vth_e = torch.sqrt(16.0 * elementary_charge * F["eps_old"].val
                           / (3.0 * pi * me))

        # energy equation: 5/3-scaled mobility, 1.3333 vth, secondary
        # electrons carry we_metallic each (`fedm-gd.py:379-382`)
        drift_en = abs_(self.signs[ie] * (5.0 / 3.0)
                             * F["mu_si"][ie].val * En)
        contribs = [fb.mass(
            fr[ie] * (0.5 * 1.3333 * vth_e + drift_en) * F["w"].exp().val
            - 2.0 * gamma * cfg.we_metallic * Ion_flux
            / (1.0 + self.ref_coeffs[ie]))]
        zero = torch.zeros_like(contribs[0])

        for i in range(1, ns):
            eq = self.equation_types[i]
            if eq == "reaction":
                contribs.append(zero)
                continue
            n_val = F["uQ"][i].exp().val
            if eq == "diffusion-reaction":
                # heavy thermal outflux: fr * 0.5 vth e^u
                contribs.append(
                    fb.mass(fr[i] * 0.5 * self.vth_heavy[i] * n_val))
                continue
            drift = abs_(self.signs[i] * F["mu_si"][i].val * En)
            if self.particle_types[i] == "electrons":
                contribs.append(fb.mass(
                    fr[i] * (0.5 * vth_e + drift) * n_val
                    - 2.0 * gamma * Ion_flux / (1.0 + self.ref_coeffs[i])))
            else:
                contribs.append(fb.mass(
                    fr[i] * (0.5 * self.vth_heavy[i] + drift) * n_val))

        contribs.append(zero)  # Poisson: Dirichlet only
        return torch.stack(contribs, dim=-1)

    # -- initial state ------------------------------------------------------

    def initial_state(self) -> TimeState:
        """Uniform initial densities and mean energy, and the initial
        Poisson solve (`fedm-gd.py:288-300`) with rho over all charged
        species, in float64 on the batch's tables."""
        cfg, ns, ie = self.cfg, self.n_species, self.ie
        dev, f64 = self.device, torch.float64
        n_dofs = self.space.n_dofs
        u = np.zeros((n_dofs, self.n_eq))
        for i in range(1, ns):
            u[:, i] = np.log(self.n_ic[i])
        u[:, 0] = np.log(cfg.mean_energy_init) + np.log(self.n_ic[ie])
        u = torch.as_tensor(u, dtype=f64, device=dev)

        b64 = self.batch.astype(f64)
        rho_q = 0.0
        for i in range(1, ns):
            if self.signs[i]:
                rho_q = rho_q + self.signs[i] * torch.exp(
                    b64.value(b64.gather(u[:, i])))
        rho_q = rho_q * (elementary_charge / epsilon_0)
        if not isinstance(rho_q, torch.Tensor):
            rho_q = torch.zeros_like(self.batch.scale)
        coords = self.space.dof_coords
        mask = np.isclose(coords[:, 1], 0.0) | np.isclose(
            coords[:, 1], cfg.gap_length)
        g = torch.zeros(n_dofs, dtype=f64, device=dev)  # U0*(1-exp(0)) = 0
        phi, _, _ = solve_poisson(self.batch, rho_q,
                                  torch.as_tensor(mask, device=dev), g,
                                  tol=1e-12)
        u[:, self.n_eq - 1] = phi
        if self._dist is not None:
            u = self._dist.to_dist(u)
        # u_old1 = 0 as the reference initialises it; the first step runs
        # as BDF1, so it does not enter
        return TimeState(u=u, u_old=u, u_old1=torch.zeros_like(u), t=0.0,
                         dt=cfg.dt_init, dt_old=1e30)

    # -- run ----------------------------------------------------------------

    def make_driver(self, error_log=None, verbose=False,
                    **kw) -> AdaptiveDriver:
        """The adaptive driver monitoring the energy density (index 0)."""
        return AdaptiveDriver(
            self.system, monitor_idx=0, ttol=self.cfg.ttol,
            dt_min=self.cfg.dt_min, dt_max=self.cfg.dt_max,
            error_log=error_log, verbose=verbose, **kw)

    def run(self, T_final: Optional[float] = None, error_log=None,
            verbose: bool = False, max_steps: int = 100000) -> TimeState:
        T = T_final if T_final is not None else self.cfg.T_final
        driver = self.make_driver(error_log, verbose)
        state = self.initial_state()
        while state.t < T and state.n_accepted < max_steps:
            state = driver.advance(state, self._update_aux(state.u))
        return state
