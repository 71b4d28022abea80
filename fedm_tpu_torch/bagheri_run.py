"""The Bagheri et al. (PSST 27, 2018) streamer benchmark end to end, on the
port: `tools/bagheri_run.py` of the JAX package, with the same flags,
presets, checkpoints and logs.

    python -m fedm_tpu_torch.bagheri_run --preset bagheri14 --out DIR \\
        [--device cuda] [--T 1.4e-8]
    python -m fedm_tpu_torch.bagheri_run --out DIR --resume ...

It runs U = 18.75 kV across a 1.25 cm gap of 760 Torr air from t = 0 (or
from DIR/checkpoint.npz with --resume): float32 compute with the float64
defect (--hi-res), or float64 (--f64); the moving fine-dz window
(--window-dz) that follows the ionisation front, re-centred whenever the
front nears its leading third; the host sparse-direct Newton rescue
(--direct-rescue) or a float64 escalation model for the steps the primary
Newton refuses; the Poisson-row preconditioner (--precond), transport
z-lines (--tzline) and row equilibration (--row-scaled); periodic
checkpoints that carry the window's geometry and the protocol in their
meta; `relative error.log` and `newton.log` in DIR.

--devices N (N > 1) runs N ranks, one per card (`parallel.ranks`: NCCL on
CUDA, gloo ranks with --device cpu), the model and its float64 escalation
model on z-slabs (`CoupledSystem.use_gspmd`, `parallel.slabs`), as the JAX
tool shards them over N chips; rank 0 prints the reports and writes the
checkpoints (the gathered state) and the logs, and a resume reads the
checkpoint on every rank and keeps each rank's rows. Every --precond goes
onto the slabs with the model (`mg`, the point-smoothed geometric
multigrid, as `parallel.slabs.SlabGeometricMG`). More ranks than cards
raise; --direct-rescue stays single-card, as in the JAX tool.
As in the JAX tool, --f64 runs on the static --full-gap mesh only, not
with a moving window, and a window moves only under the structured
--precond mg-zline.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Named production protocols: a preset sets flag defaults; explicit flags
# still override. The same dicts as tools/bagheri_run.py.
PRESETS = {
    # the 14 ns flagship: uniform-1e-5 wall, hi-residual f32 Newton, the
    # full rescue stack
    "bagheri14": dict(
        window_dz=1e-5, window_span=1.5e-3, tail_cells="10,48",
        dr=2e-5, r1=2e-3, hi_res=True, no_fallback=True, stab="off",
        linear_tol=1e-2, checkpoint_every=25, report_every=10,
        predictor=1.0, fail_dt_cap=0.7, true_res_rescue=1.0,
        direct_rescue=True),
    # the finish protocol: the static full-gap uniform-1e-5 mesh
    "bagheri14-fullgap": dict(
        window_dz=1e-5, window_span=1.5e-3, tail_cells="10,10",
        full_gap=True, dr=2e-5, r1=2e-3, hi_res=True, no_fallback=True,
        stab="off", linear_tol=1e-2, linear_maxiter=150,
        linear_stall_window=25, checkpoint_every=25, report_every=10,
        predictor=1.0, fail_dt_cap=0.7, true_res_rescue=1.0,
        direct_rescue=False),
}

# an axis node belongs to the streamer above this electron density [m^-3]
FRONT_DENSITY = 1e18
Z_LO_MIN = 1e-4   # window clamp: the tails keep a positive extent
Z_HI_MAX = 1.19e-2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fedm_tpu_torch.bagheri_run",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None,
                    help="named production protocol: sets flag defaults "
                         "(explicit flags override); recorded in every "
                         "checkpoint's meta")
    ap.add_argument("--out", type=Path, required=True,
                    help="output directory (checkpoints, logs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    ap.add_argument("--dz", type=float, default=2e-5,
                    help="static corridor dz on [0, 1.08e-2] (no window)")
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--dr", type=float, default=None,
                    help="r-corridor: uniform dr on [0, --r1]")
    ap.add_argument("--r1", type=float, default=2e-3,
                    help="r-corridor fine-region extent [m]")
    ap.add_argument("--T", type=float, default=1.4e-8)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--resume-dt", type=float, default=None,
                    help="dt of the backward-Euler restart step of a "
                         "cross-resolution or --restart-bdf resume "
                         "(default: the checkpoint's dt)")
    ap.add_argument("--restart-bdf", action="store_true",
                    help="restart the BDF history (backward-Euler first "
                         "step at --resume-dt) on a same-mesh resume")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--report-every", type=int, default=25)
    ap.add_argument("--f64", action="store_true",
                    help="float64 compute (no escalation)")
    ap.add_argument("--stab", default="peclet",
                    choices=["off", "peclet", "linear"])
    ap.add_argument("--precond", default="mg-zline",
                    choices=["mg", "mg-zline", "zline"])
    ap.add_argument("--max-steps", type=int, default=100000)
    ap.add_argument("--row-scaled", action="store_true",
                    help="row equilibration by the assembled l1 row norms "
                         "(StreamerConfig.row_scaled)")
    ap.add_argument("--no-floor", action="store_true",
                    help="disable the far-field background density floor")
    ap.add_argument("--rtol", type=float, default=None,
                    help="override Newton rtol")
    ap.add_argument("--linear-maxiter", type=int, default=400,
                    help="inner Krylov iteration cap")
    ap.add_argument("--linear-tol", type=float, default=1e-4,
                    help="inner Krylov relative tolerance")
    ap.add_argument("--linear-stall-window", type=int, default=0,
                    help="NewtonConfig.linear_stall_window (0 disables)")
    ap.add_argument("--hi-res", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="float64 Newton defect with the float32 Krylov "
                         "correction (NewtonConfig.hi_residual)")
    ap.add_argument("--true-res-rescue", type=float, default=0.0,
                    help="NewtonConfig.true_res_rescue (0 disables)")
    ap.add_argument("--floor-atol", type=float, default=0.0,
                    help="AdaptiveDriver.floor_atol (0 disables)")
    ap.add_argument("--log-clip", type=float, default=0.0,
                    help="NewtonConfig.delta_clip on the log-density "
                         "columns, in log-units (0 disables)")
    ap.add_argument("--accept-reduction", type=float, default=3e-2,
                    help="NewtonConfig.accept_reduction, in [0, 1)")
    ap.add_argument("--verbose", action="store_true",
                    help="per-attempt Newton diagnostics")
    ap.add_argument("--diag-guards", action="store_true",
                    help="report the count of node blocks that take the "
                         "Jacobi fallback at each report")
    ap.add_argument("--direct-rescue", action="store_true",
                    help="host sparse-direct Newton escalation "
                         "(solvers.direct.DirectNewton); needs "
                         "--no-fallback or --f64")
    ap.add_argument("--no-fallback", action="store_true",
                    help="float32 only: no float64 escalation system")
    ap.add_argument("--fallback", dest="no_fallback", action="store_false",
                    help="re-enable the float64 escalation over a "
                         "preset's no_fallback=True")
    ap.add_argument("--linear-solver", default=None,
                    choices=[None, "bicgstab", "gmres"],
                    help="override the Newton inner solver")
    ap.add_argument("--window-dz", type=float, default=None,
                    help="moving-window mode: fine dz inside the window")
    ap.add_argument("--window-span", type=float, default=1.5e-3,
                    help="window length [m] (60%% ahead of the front, "
                         "40%% behind)")
    ap.add_argument("--tail-cells", default="48,48",
                    help="window z-tail cell counts 'lo,hi' "
                         "(StreamerConfig.z_tail_cells)")
    ap.add_argument("--wall-dz", type=float, default=None,
                    help="wall-clustered lower tail: first cell size at "
                         "the cathode (StreamerConfig.z_wall_dz)")
    ap.add_argument("--tzline", action="store_true",
                    help="transport z-line preconditioning of the electron "
                         "row (StreamerConfig.transport_zline)")
    ap.add_argument("--predictor", type=float, default=0.0,
                    help="AdaptiveDriver.predictor (0 = off)")
    ap.add_argument("--fail-dt-cap", type=float, default=0.0,
                    help="AdaptiveDriver.fail_dt_cap (0 = off)")
    ap.add_argument("--no-direct-rescue", action="store_true",
                    help="override a preset's --direct-rescue")
    ap.add_argument("--full-gap", action="store_true",
                    help="static full-gap corridor at --window-dz (no "
                         "window moves)")
    ap.add_argument("--devices", type=int, default=1,
                    help="cards to run on, one rank each, the state in "
                         "z-slabs (with --device cpu: gloo ranks)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = build_parser()
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--preset", choices=sorted(PRESETS), default=None)
    known, _ = pre.parse_known_args(argv)
    # set_defaults accepts keys that match no flag: refuse a preset typo
    dests = {a.dest for a in ap._actions}
    for pname, pdict in PRESETS.items():
        unknown = set(pdict) - dests
        if unknown:
            ap.error(f"preset {pname!r} sets unknown keys: {sorted(unknown)}")
    if known.preset is not None:
        ap.set_defaults(**PRESETS[known.preset])
    args = ap.parse_args(argv)
    if args.no_direct_rescue:
        args.direct_rescue = False
    if not 0.0 <= args.accept_reduction < 1.0:
        ap.error(f"--accept-reduction must be in [0, 1): "
                 f"{args.accept_reduction}")
    if args.devices < 1:
        ap.error(f"--devices must be at least 1: {args.devices}")
    if args.devices > 1 and args.direct_rescue:
        ap.error("--direct-rescue is single-card (as in the JAX tool): pass "
                 "--no-direct-rescue with --devices > 1")
    if args.direct_rescue and not (args.no_fallback or args.f64):
        ap.error("--direct-rescue replaces the float64 escalation: pass "
                 "--no-fallback (or --f64)")
    if args.window_dz is not None and not args.no_fallback:
        ap.error("--window-dz needs --no-fallback: the float64 escalation "
                 "model does not follow window moves")
    if args.window_dz is not None and args.f64 and not args.full_gap:
        ap.error("--f64 with a moving window: the reference tool refuses "
                 "this combination, so it has no run to hold the port to; "
                 "--f64 takes the static --full-gap mesh")
    return args


def window_corr(front: float, span: float, dz: float) -> tuple:
    """The window (z_lo, z_hi, dz) for a front at `front`: 60 % of the span
    below it, 40 % above, shifted (never shrunk) into
    [Z_LO_MIN, Z_HI_MAX]."""
    z_lo = front - 0.6 * span
    z_hi = front + 0.4 * span
    if z_hi > Z_HI_MAX:
        z_lo, z_hi = Z_HI_MAX - span, Z_HI_MAX
    if z_lo < Z_LO_MIN:
        z_lo, z_hi = Z_LO_MIN, Z_LO_MIN + span
    return (z_lo, z_hi, dz)


def full_gap_corr(dz: float) -> tuple:
    """The static full-gap corridor at `dz`: the gap less two uniform
    10-cell tails."""
    return (Z_LO_MIN, 1.25e-2 - 10 * dz, dz)


def build_models(args: argparse.Namespace, corridor: tuple, group=None):
    """The run's model on the z-corridor `corridor` and, unless
    --no-fallback or --f64, its float64 escalation model on the same mesh;
    both on --device with the structured assembly, and with a `group`
    (`parallel.ranks`) both on its z-slabs (`use_gspmd`)."""
    from .models.streamer import StreamerConfig, StreamerModel
    from .solvers.newton import NewtonConfig

    common = dict(nx=args.nx, z_corridor=corridor, stab_mode=args.stab,
                  poisson_precond=args.precond, T_final=args.T,
                  row_scaled=args.row_scaled,
                  transport_zline=args.tzline)
    if args.window_dz is not None:
        tail_cells = tuple(int(v) for v in args.tail_cells.split(","))
        if len(tail_cells) != 2:
            raise SystemExit("--tail-cells takes two counts 'lo,hi'")
        common["z_tail_cells"] = tail_cells
        if args.wall_dz is not None:
            common["z_wall_dz"] = args.wall_dz
    if args.dr is not None:
        common["r_corridor"] = (args.r1, args.dr)
    if not args.no_floor:
        common["density_floor"] = 1e13  # = cfg.background
    # species columns clamped, the potential column free
    delta_clip = ((args.log_clip, args.log_clip, float("inf"))
                  if args.log_clip > 0 else ())
    newton = dict(max_iter=20, linear_tol=args.linear_tol,
                  linear_maxiter=args.linear_maxiter,
                  linear_stall_window=args.linear_stall_window,
                  linear_solver=args.linear_solver or "bicgstab",
                  accept_reduction=args.accept_reduction,
                  true_res_rescue=args.true_res_rescue,
                  delta_clip=delta_clip, host_loop=True)
    fallback = None
    if args.f64:
        nc = NewtonConfig(rtol=args.rtol or 1e-3, **newton)
        model = StreamerModel(StreamerConfig(newton=nc, **common),
                              device=args.device)
    else:
        nc = NewtonConfig(rtol=args.rtol or (1e-3 if args.hi_res else 3e-3),
                          hi_residual=args.hi_res, **newton)
        model = StreamerModel(StreamerConfig(dtype=torch.float32, newton=nc,
                                             **common), device=args.device)
        if not args.no_fallback:
            fallback = StreamerModel(StreamerConfig(**common),
                                     mesh=model.mesh, device=args.device)
            fallback.system.use_gather_scatter()
    model.system.use_gather_scatter()
    if group is not None:
        model.system.use_gspmd(group)
        if fallback is not None:
            fallback.system.use_gspmd(group)
    return model, fallback


def build_driver(args: argparse.Namespace, model, fallback=None,
                 logs: bool = True):
    """The run's adaptive driver, writing `relative error.log`,
    `newton.log` and, on a dt_min death, `crash.npz` into --out (with
    `logs`; on z-slabs rank 0 writes them); its fallback is the direct
    rescue with --direct-rescue, else the float64 model's system, if
    any."""
    from .solvers.direct import DirectNewton
    from .timestepping import AdaptiveDriver

    if args.direct_rescue:
        fallback_system = DirectNewton(model.system, verbose=args.verbose)
    else:
        fallback_system = None if fallback is None else fallback.system
    return AdaptiveDriver(
        model.system, monitor_idx=1, ttol=model.cfg.ttol,
        dt_min=model.cfg.dt_min, dt_max=model.cfg.dt_max,
        error_log=args.out / "relative error.log" if logs else None,
        fallback_system=fallback_system,
        crash_checkpoint=args.out / "crash.npz" if logs else None,
        post_accept=model.floor_projection(), verbose=args.verbose,
        fail_dt_cap=args.fail_dt_cap, predictor=args.predictor,
        newton_log=args.out / "newton.log" if logs else None,
        floor_atol=args.floor_atol)


def main(argv=None) -> int:
    args = parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    protocol = {k: (str(v) if isinstance(v, Path) else v)
                for k, v in sorted(vars(args).items())}
    print(f"protocol: {json.dumps(protocol)}", flush=True)
    if args.devices == 1:
        return run(None, args, protocol)
    from .parallel import ranks

    ranks.ranked(run, args.devices, args.device, (args, protocol))
    return 0


def run(group, args: argparse.Namespace, protocol: dict) -> int:
    """The run on one card (`group` None), or this rank's part of it on
    z-slabs over `group` (`parallel.ranks.Group`): every rank steps its
    rows and takes the same decisions; rank 0 prints and writes."""
    from .io.checkpoint import load_checkpoint, save_checkpoint
    from .models.streamer import z_coords
    from .timestepping import TimeState, restart_bdf_history

    lead = group is None or group.rank == 0
    if group is not None:
        args = argparse.Namespace(**{**vars(args),
                                     "device": str(group.device)})
        if not lead:   # rank 0 writes the logs
            args = argparse.Namespace(**{**vars(args), "verbose": False})

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    window = args.window_dz is not None
    span = args.window_span
    ckpt = args.out / "checkpoint.npz"
    src_corridor = None
    if window:
        fg_corr = full_gap_corr(args.window_dz)
        corridor = (fg_corr if args.full_gap
                    else window_corr(1e-2, span, args.window_dz))
        if args.resume and ckpt.exists():
            # the corridor the state lives on travels in the checkpoint
            _, meta = load_checkpoint(ckpt, device="cpu", with_meta=True)
            if "z_corridor" in meta:
                corridor = tuple(float(v) for v in meta["z_corridor"])
            elif (args.out / "window.json").exists():
                corridor = tuple(json.loads(
                    (args.out / "window.json").read_text()))
            # the window's position comes from the checkpoint; its dz may
            # change across a resume (the state is z-remapped below)
            src_corridor = corridor
            if args.full_gap:
                corridor = fg_corr
            elif corridor[2] != args.window_dz:
                corridor = (corridor[0], corridor[1], args.window_dz)
    else:
        corridor = (0.0, 1.08e-2, args.dz)
    model, fallback = build_models(args, corridor, group)
    n_dofs = model.space.n_dofs
    dev = model.device
    say(f"device: {dev}"
        + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
           else "")
        + ("" if group is None else
           f", {group.size} ranks on z-slabs, node rows "
           f"{model.system.slabs.layout.counts()}, Poisson row "
           f"{type(model.system._ell[1].__self__).__name__}"))
    corr = model.cfg.z_corridor
    say(f"mesh: {n_dofs} dofs ({3 * n_dofs} unknowns), "
        f"z_corridor=({corr[0]:.4e},{corr[1]:.4e},dz={corr[2]:g})"
        f"{' [moving]' if window else ''}, stab={args.stab}, "
        f"precond={args.precond}, dtype={'f64' if args.f64 else 'f32'}")
    driver = build_driver(args, model, fallback, logs=lead)

    if args.resume and ckpt.exists():
        state, meta = load_checkpoint(ckpt, device=dev, with_meta=True)
        # a state lives on the z-lines its writer's geometry produced: a
        # change of --wall-dz, --window-dz or the tails remaps it along z
        src_wall = float(meta["z_wall_dz"]) if "z_wall_dz" in meta else None
        # checkpoints without the meta entry were written with (48, 48)
        src_tails = (tuple(int(v) for v in meta["z_tail_cells"])
                     if "z_tail_cells" in meta else (48, 48))
        if window and (src_wall != args.wall_dz
                       or src_corridor != model.cfg.z_corridor
                       or src_tails != model.cfg.z_tail_cells):
            cfg_src = dataclasses.replace(model.cfg, z_wall_dz=src_wall,
                                          z_corridor=src_corridor,
                                          z_tail_cells=src_tails)
            zs_src = z_coords(cfg_src)
            zs_dst = np.unique(model.mesh.coords[:, 1])
            n_r = len(np.unique(model.mesh.coords[:, 0]))
            # restrict: a cross-resolution resume averages locally coarser
            # regions instead of sampling them
            state = model._remap_z(state, zs_src, zs_dst, n_r, restrict=True)
            say(f"remapped checkpoint z-lines: wall-dz {src_wall} -> "
                f"{args.wall_dz}, corridor dz {src_corridor[2]:g} -> "
                f"{model.cfg.z_corridor[2]:g}, tails {src_tails} -> "
                f"{model.cfg.z_tail_cells} ({len(zs_src)} -> "
                f"{len(zs_dst)} z-lines; wall cell "
                f"{zs_src[1] - zs_src[0]:.2e} -> "
                f"{zs_dst[1] - zs_dst[0]:.2e})")
            # the remap invalidates the BDF2 history
            state = restart_bdf_history(state, dt=args.resume_dt)
            say(f"cross-resolution remap: BDF history restarted "
                f"(backward-Euler first step, dt={state.dt:.3e})")
        if args.restart_bdf:
            state = restart_bdf_history(state, dt=args.resume_dt)
            say(f"--restart-bdf: BDF history restarted (backward-Euler "
                f"first step, dt={state.dt:.3e})")
        say(f"resumed from {ckpt}: t={state.t:.4e}, "
            f"{state.n_accepted} steps")
        # every rank read the whole state: keep its rows
        place = model.system.place_state
        state.u, state.u_old, state.u_old1 = (
            place(state.u), place(state.u_old), place(state.u_old1))
    else:
        state = model.initial_state()
    whole = model.system.gather_state

    def whole_state(st):
        """`st` with the whole grid's fields (gathered on z-slabs)."""
        return TimeState(u=whole(st.u), u_old=whole(st.u_old),
                         u_old1=whole(st.u_old1), t=st.t, dt=st.dt,
                         dt_old=st.dt_old, max_error=st.max_error,
                         n_accepted=st.n_accepted, n_rejected=st.n_rejected)

    def axis_nodes():
        coords = model.space.dof_coords
        axis = np.isclose(coords[:, 0], 0.0)
        return axis, coords[axis, 1]

    axis, z_axis = axis_nodes()

    def report(state, wall, n_since) -> float:
        u = whole(state.u).cpu().numpy()
        ne_axis = np.exp(u[axis, 1])
        in_streamer = ne_axis > FRONT_DENSITY
        front = (float(z_axis[in_streamer].min()) if in_streamer.any()
                 else float("nan"))
        order = np.argsort(z_axis)
        Ez = -np.gradient(u[axis, 2][order], z_axis[order])
        guards = ""
        if args.diag_guards:
            from .model.system import StepParams

            n_g = model.system.guarded_block_count(
                state.u, state.u_old, StepParams(state.t, state.dt,
                                                 state.dt_old))
            guards = f" n_guarded={n_g}"
        say(f"t={state.t:.4e} dt={state.dt:.3e} steps={state.n_accepted} "
            f"rej={state.n_rejected} esc={driver.n_escalated} "
            f"stall={driver.n_stall_accepted} "
            f"ne_max={ne_axis.max():.3e} front_z={front:.4e} "
            f"Emax={np.abs(Ez).max():.3e}{guards} "
            f"[{n_since / max(wall, 1e-9):.2f} steps/s]")
        return front

    def ckpt_meta() -> dict:
        # the protocol in every checkpoint, and the window's geometry
        meta = {"protocol": json.dumps(protocol)}
        if not window:
            return meta
        meta.update({"z_corridor": model.cfg.z_corridor,
                     "z_tail_cells": model.cfg.z_tail_cells})
        if model.cfg.z_wall_dz is not None:
            meta["z_wall_dz"] = model.cfg.z_wall_dz
        return meta

    # a crash checkpoint carries the same meta as the periodic ones
    driver.crash_meta = ckpt_meta

    def save(path):
        st = whole_state(state)   # on z-slabs a collective
        if not lead:
            return
        save_checkpoint(path, st, meta=ckpt_meta())
        if window:  # human-readable only; a resume reads the meta
            (args.out / "window.json").write_text(
                json.dumps(list(model.cfg.z_corridor)))

    T = args.T
    t_wall = time.perf_counter()
    n_last = last_saved = state.n_accepted
    while state.t < T * (1 - 1e-12) and state.n_accepted < args.max_steps:
        state.dt = min(state.dt, T - state.t)
        state = driver.advance(state, {})
        # fire on a change of n_accepted only
        if (state.n_accepted % args.report_every == 0
                and state.n_accepted != n_last):
            now = time.perf_counter()
            front = report(state, now - t_wall, state.n_accepted - n_last)
            t_wall, n_last = now, state.n_accepted
            # re-centre the window once the front nears its leading third
            z_lo = model.cfg.z_corridor[0]
            if (window and not args.full_gap and np.isfinite(front)
                    and front < z_lo + 0.35 * span):
                new_corr = window_corr(front, span, args.window_dz)
                if abs(new_corr[0] - z_lo) > 1e-12:
                    say(f"REMESH: window {model.cfg.z_corridor} -> "
                        f"{new_corr} (front at {front:.4e})")
                    t_rm = time.perf_counter()
                    state = model.move_window(new_corr, state)
                    say(f"REMESH done in {time.perf_counter() - t_rm:.2f}s")
                    axis, z_axis = axis_nodes()
                    save(ckpt)
                    last_saved = state.n_accepted
        if (state.n_accepted % args.checkpoint_every == 0
                and state.n_accepted != last_saved):
            save(ckpt)
            last_saved = state.n_accepted
            # a trail of restart points
            if state.n_accepted % (10 * args.checkpoint_every) == 0:
                save(args.out / f"checkpoint_{state.n_accepted:06d}.npz")

    save(ckpt)
    report(state, time.perf_counter() - t_wall, state.n_accepted - n_last)
    done = state.t >= T * (1 - 1e-12)
    say(f"{'REACHED T_final' if done else 'STOPPED'} at t={state.t:.6e} "
        f"({state.n_accepted} accepted, {state.n_rejected} rejected, "
        f"{driver.n_escalated} escalated, {driver.n_stall_accepted} "
        f"stall-accepted this segment)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
