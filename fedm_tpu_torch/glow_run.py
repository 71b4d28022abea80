"""The low-pressure argon glow discharge end to end, on the port:
`tools/glow_run.py` of the JAX package, with the same flags, presets,
checkpoints and report line.

    python -m fedm_tpu_torch.glow_run --preset glow50 --out DIR
        [--device cuda] [--nx 64 --ny 64] [--T 5e-5] [--max-steps N]
    python -m fedm_tpu_torch.glow_run --preset glow50 --out DIR --resume

The reference's flagship LMEA case (`fedm-gd.py`: 1 Torr argon,
U = -250 V ramped, T_final = 5e-5 s) on a crossed nx x ny mesh, from t = 0
or from DIR/checkpoint.npz: float32 compute with the float64 defect
(--f32 --hi-res), or float64; periodic checkpoints that carry the protocol
in their meta; `relative_error.log` and `newton.log` in DIR.

The chemistry is read from --file-input/4_particles/, as the JAX tool
reads it. Without --file-input the synthetic argon tree (`models.argon_synth`:
the reference's file formats and scheme structure) is generated as
DIR/file_input/argon_synth/ and read from there; the JAX tool's default
instead points at the reference's Becker et al. `4_particles` tables,
which are not part of this repository.
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
# still override. The same dict as tools/glow_run.py.
PRESETS = {
    "glow50": dict(f32=True, hi_res=True, no_fallback=True,
                   linear_tol=1e-2, checkpoint_every=100,
                   report_every=50),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fedm_tpu_torch.glow_run",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None,
                    help="named production protocol (flag defaults; "
                         "explicit flags still override); recorded in "
                         "checkpoint meta")
    ap.add_argument("--out", type=Path, required=True,
                    help="output directory (checkpoints, logs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--T", type=float, default=5e-5)
    ap.add_argument("--ttol", type=float, default=5e-4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="float32 compute with the float64 escalation "
                         "fallback")
    ap.add_argument("--hi-res", action="store_true",
                    help="with --f32: float64 Newton defect with the "
                         "float32 Krylov correction "
                         "(NewtonConfig.hi_residual), rtol 1e-3")
    ap.add_argument("--verbose", action="store_true",
                    help="per-attempt Newton diagnostics from the driver")
    ap.add_argument("--no-fallback", action="store_true",
                    help="with --f32: no float64 escalation system; Newton "
                         "failures shrink dt instead")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--report-every", type=int, default=50)
    ap.add_argument("--linear-tol", type=float, default=1e-4,
                    help="inner Krylov relative tolerance")
    ap.add_argument("--fail-dt-cap", type=float, default=0.0,
                    help="AdaptiveDriver.fail_dt_cap (0 = off)")
    ap.add_argument("--predictor", type=float, default=0.0,
                    help="AdaptiveDriver.predictor (0 = off)")
    ap.add_argument("--max-steps", type=int, default=200000)
    ap.add_argument("--file-input", type=Path, default=None,
                    help="directory holding the reference's 4_particles/ "
                         "tree (default: generate the synthetic argon tree "
                         "argon_synth/ under OUT/file_input; the JAX "
                         "tool's default is the reference's 4_particles "
                         "tables, not in this repository)")
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
    return ap.parse_args(argv)


def build_models(args: argparse.Namespace):
    """The run's model on --device and, for --f32 without --no-fallback,
    its float64 escalation model, both on the ELL assembly."""
    from .models.argon_synth import generate_argon_input
    from .models.glow import GlowConfig, GlowDischargeModel
    from .solvers.newton import NewtonConfig

    file_input = args.file_input
    model_name = "4_particles"
    if file_input is None:
        file_input, model_name = args.out / "file_input", "argon_synth"
        if not (file_input / model_name).exists():
            generate_argon_input(file_input, model=model_name)
    common = dict(model=model_name, file_input=file_input, nx=args.nx,
                  ny=args.ny, ttol=args.ttol, T_final=args.T)
    fallback = None
    if args.f32:
        if args.hi_res:
            nc = NewtonConfig(rtol=1e-3, max_iter=20,
                              linear_tol=args.linear_tol,
                              linear_maxiter=600, hi_residual=True,
                              host_loop=True)
        else:
            nc = NewtonConfig(rtol=5e-3, max_iter=20,
                              linear_tol=args.linear_tol, linear_maxiter=600)
        model = GlowDischargeModel(GlowConfig(dtype=torch.float32, newton=nc,
                                              **common), device=args.device)
        if not args.no_fallback:
            fallback = GlowDischargeModel(GlowConfig(**common),
                                          device=args.device)
            fallback.system.use_gather_scatter()
    else:
        model = GlowDischargeModel(GlowConfig(**common), device=args.device)
        model.system.newton = dataclasses.replace(
            model.system.newton, linear_tol=args.linear_tol)
    model.system.use_gather_scatter()
    return model, fallback


def build_driver(args: argparse.Namespace, model, fallback=None):
    """The run's adaptive driver, writing `relative_error.log`,
    `newton.log` and, on a dt_min death, `crash.npz` into --out."""
    from .timestepping import AdaptiveDriver

    return AdaptiveDriver(
        model.system, monitor_idx=0, ttol=args.ttol,
        dt_min=model.cfg.dt_min, dt_max=model.cfg.dt_max,
        error_log=args.out / "relative_error.log",
        fallback_system=None if fallback is None else fallback.system,
        crash_checkpoint=args.out / "crash.npz", verbose=args.verbose,
        fail_dt_cap=args.fail_dt_cap, predictor=args.predictor,
        newton_log=args.out / "newton.log")


def main(argv=None) -> int:
    args = parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    protocol = {k: (str(v) if isinstance(v, Path) else v)
                for k, v in sorted(vars(args).items())}
    print(f"protocol: {json.dumps(protocol)}", flush=True)

    from .io.checkpoint import load_checkpoint, save_checkpoint

    model, fallback = build_models(args)
    dev = model.device
    n_dofs = model.space.n_dofs
    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""), flush=True)
    print(f"mesh: {args.nx}x{args.ny}, {n_dofs} dofs "
          f"({model.n_eq * n_dofs} unknowns), chemistry={model.cfg.model} "
          f"({model.cfg.file_input}), dtype="
          f"{'f32' if args.f32 else 'f64'}"
          f"{'+escalation' if fallback is not None else ''}", flush=True)
    driver = build_driver(args, model, fallback)
    meta = {"protocol": json.dumps(protocol)}
    driver.crash_meta = lambda: meta

    ckpt = args.out / "checkpoint.npz"
    if args.resume and ckpt.exists():
        state = load_checkpoint(ckpt, device=dev)
        print(f"resumed from {ckpt}: t={state.t:.4e}, "
              f"{state.n_accepted} steps", flush=True)
    else:
        state = model.initial_state()

    ie, phi = model.ie, model.n_eq - 1

    def report(state, wall, n_since):
        u = state.u.cpu().numpy()
        ne = np.exp(u[:, ie])
        eps = np.exp(u[:, 0] - u[:, ie])  # mean electron energy [eV]
        print(f"t={state.t:.4e} dt={state.dt:.3e} steps={state.n_accepted} "
              f"rej={state.n_rejected} esc={driver.n_escalated} "
              f"stall={driver.n_stall_accepted} "
              f"ne_max={ne.max():.3e} eps=[{eps.min():.2f},{eps.max():.2f}] "
              f"phi=[{u[:, phi].min():.1f},{u[:, phi].max():.1f}] "
              f"[{n_since / max(wall, 1e-9):.2f} steps/s]", flush=True)

    T = args.T
    t_wall = time.perf_counter()
    n_last = last_saved = state.n_accepted
    while state.t < T and state.n_accepted < args.max_steps:
        state.dt = min(state.dt, max(T - state.t, model.cfg.dt_min))
        state = driver.advance(state, model._update_aux(state.u))
        # fire on a change of n_accepted only
        if (state.n_accepted % args.report_every == 0
                and state.n_accepted != n_last):
            now = time.perf_counter()
            report(state, now - t_wall, state.n_accepted - n_last)
            t_wall, n_last = now, state.n_accepted
        if (state.n_accepted % args.checkpoint_every == 0
                and state.n_accepted != last_saved):
            save_checkpoint(ckpt, state, meta=meta)
            last_saved = state.n_accepted
            # a trail of restart points
            if state.n_accepted % (20 * args.checkpoint_every) == 0:
                save_checkpoint(
                    args.out / f"checkpoint_{state.n_accepted:06d}.npz",
                    state, meta=meta)

    save_checkpoint(ckpt, state, meta=meta)
    report(state, time.perf_counter() - t_wall, state.n_accepted - n_last)
    done = state.t >= T * (1 - 1e-12)
    print(f"{'REACHED T_final' if done else 'STOPPED'} at t={state.t:.6e} "
          f"({state.n_accepted} accepted, {state.n_rejected} rejected, "
          f"{driver.n_escalated} escalated, {driver.n_stall_accepted} "
          f"stall-accepted this segment)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
