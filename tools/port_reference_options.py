"""Reference numbers for the PyTorch port's `rescue` and `options` smoke
phases, computed with the JAX package on the CPU.

rescue: the Bagheri streamer at the `bagheri14` protocol of
`tools/bagheri_run.py` (float32 with the float64 defect, 30,305 dofs), its
initial state moved with the window to window_corr(9.9e-3) as in
`tools/port_reference_window.py`, then one adaptive advance (the bagheri14
driver settings) whose primary Newton is too weak to converge (max_iter 1,
linear_maxiter 1, rtol 1e-10, accept_reduction 0, max_stalls 1) with
`DirectNewton(rtol=1e-3)` as the fallback: the colour and node-pair
counts, the escalations, accepted and rejected counts, t and dt, the
residual norm after each iteration of each direct step, and the
per-equation 2-norms of u_new - u_old.

options: the JAX package's default StreamerConfig (the graded 80 x 160
mesh, 13,041 dofs, float64, poisson_precond "mg") built through
`StreamerModel.from_file_input` on tests/unit/test_streamer_file_input.py's
tree: at its initial state (delta = 0, the first step), for a seeded r,
the per-column 2-norms of M r and the per-column dots of M r with a second
seeded vector, for "mg", "zline" and the transport z-line preconditioner
on "mg-zline", and the same of the row weights; then one advance in each
of "mg", "zline", transport_zline=True ("mg-zline") and row_scaled=True in
float32: accepted and rejected counts, Newton, BiCGStab and GMRES
iterations, t, dt and the accepted step's error, or the driver's exit
message; and the spread of the JAX package's own Newton and BiCGStab
counts over the same advance from the initial state scaled by
(1 + eps * noise) for six seeded noises (eps 1e-12 in float64, 1e-7 in
float32): the range a port that rounds differently may land in.

Prints one JSON line per part, which `chip_smoke.py` holds the port to.
With --port the port runs the same on the CPU and a second line per part
gives its gaps, its counts, and the controls the tolerances must refuse
(rescue: the direct steps with the line search on the float32 residual;
options: M r of the float32 model).

    JAX_PLATFORMS=cpu python tools/port_reference_options.py \
        [--part rescue|options|both] [--port]
"""

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402

import fedm_tpu  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from fedm_tpu.model.system import StepParams  # noqa: E402
from fedm_tpu.models.streamer import StreamerConfig, StreamerModel  # noqa: E402
from fedm_tpu.solvers.newton import NewtonConfig  # noqa: E402

import port_reference_window as prw  # noqa: E402

WEAK = dict(max_iter=1, linear_maxiter=1, rtol=1e-10, accept_reduction=0.0,
            max_stalls=1)
OPTIONS = {"mg": dict(), "zline": dict(poisson_precond="zline"),
           "tzline": dict(poisson_precond="mg-zline", transport_zline=True),
           "row_scaled_f32": dict(row_scaled=True)}
PRECONDS = ("mg", "zline", "tzline")


def write_tree(base: Path) -> Path:
    """tests/unit/test_streamer_file_input.py's reference-format tree (the
    Bagheri closed forms as `fun:E` expressions) under `base`."""
    header = "# Dependence:  {dep}\n"
    model = base / "benchmark_model"
    tc = model / "transport_coefficients"
    tc.mkdir(parents=True, exist_ok=True)
    (model / "species").mkdir(exist_ok=True)
    (model / "speclist.cfg").write_text(
        "neutrals    file: neutrals.cfg\nions        file: ions.cfg\n"
        "e           file: electrons.cfg\n")
    for sp, z, mass in [("neutrals", 0, 4.7e-26), ("ions", 1, 4.7e-26),
                        ("electrons", -1, 9.10938356e-31)]:
        (model / "species" / f"{sp}.cfg").write_text(
            f"Z    = {z}\nMass = {mass}\nNmom = 2\n")
    (tc / "e_Nb.dat").write_text(header.format(dep="fun:E")
                                 + "2.3987*E_m**(-0.26)\n")
    (tc / "e_ND.dat").write_text(header.format(dep="fun:E")
                                 + "4.3628e-3*E_m**(0.22)\n")
    for sp in ("ions", "neutrals"):
        (tc / f"{sp}_Nb.dat").write_text(header.format(dep="const") + "0.0\n")
        (tc / f"{sp}_ND.dat").write_text(header.format(dep="const") + "0.0\n")
    (tc / "alpha.dat").write_text(
        header.format(dep="fun:E")
        + "(1.1944e6 + 4.3666e26 * E_m**(-3))*exp(-2.73e7/E_m)-340.75\n")
    return base


def seeded(n_dofs: int):
    """(r, v): the seeded right-hand side and test vector [n_dofs, 3]."""
    return (np.random.default_rng(0).standard_normal((n_dofs, 3)),
            np.random.default_rng(1).standard_normal((n_dofs, 3)))


def column_stats(x, v) -> dict:
    x = np.asarray(x, np.float64)
    return {"norms": [float(np.linalg.norm(x[:, k])) for k in range(3)],
            "dots": [float(x[:, k] @ v[:, k]) for k in range(3)]}


def rel_gaps(got: dict, ref: dict) -> list:
    return [abs(a - b) / abs(b) if b else abs(a)
            for key in ("norms", "dots")
            for a, b in zip(got[key], ref[key])]


# -- rescue ------------------------------------------------------------------

def history_from(norms: list, n_steps_iters: list) -> list:
    """Per direct step, the residual norm at its start and after each
    accepted iteration, from the sequence of every residual norm the steps
    evaluated: an evaluation below the norm in force is accepted (the
    backtracking's rule). `n_steps_iters` gives each step's (number of
    evaluations)."""
    out, i = [], 0
    for n in n_steps_iters:
        seq = norms[i:i + n]
        i += n
        hist = [seq[0]]
        for f in seq[1:]:
            if np.isfinite(f) and f < hist[-1]:
                hist.append(f)
        out.append(hist)
    return out


def jax_rescue() -> dict:
    from fedm_tpu.solvers.direct import DirectNewton
    from fedm_tpu.timestepping import AdaptiveDriver

    nc = NewtonConfig(rtol=1e-3, max_iter=20, linear_tol=1e-2,
                      linear_maxiter=400, accept_reduction=3e-2,
                      host_loop=True, hi_residual=True, true_res_rescue=1.0)
    cfg = StreamerConfig(dtype=jnp.float32, newton=replace(nc, **WEAK),
                         nx=96, z_corridor=prw.window_corr(1e-2),
                         z_tail_cells=(10, 48), r_corridor=(2e-3, 2e-5),
                         stab_mode="off", poisson_precond="mg-zline",
                         density_floor=1e13)
    model = StreamerModel(cfg)
    model.system.use_gather_scatter()
    model.system.enable_geom_mode()
    s = model.move_window(prw.window_corr(9.9e-3), model.initial_state())
    dn = DirectNewton(model.system, rtol=1e-3)
    dn.prepare()
    dn._build_jits()
    norms, per_step = [], []
    res, step = dn._res_jit, dn.step

    def recorded(*a):
        out = res(*a)
        norms.append(float(np.linalg.norm(np.asarray(out, np.float64))))
        return out

    def counted_step(*a, **kw):
        n0 = len(norms)
        out = step(*a, **kw)
        per_step.append(len(norms) - n0)
        return out

    dn._res_jit = recorded
    dn.step = counted_step
    driver = AdaptiveDriver(
        model.system, monitor_idx=1, ttol=cfg.ttol, dt_min=cfg.dt_min,
        dt_max=cfg.dt_max, post_accept=model.floor_projection(),
        fail_dt_cap=0.7, predictor=1.0, fallback_system=dn)
    t0 = time.perf_counter()
    s1 = driver.advance(s, {})
    du = np.asarray(s1.u) - np.asarray(s.u)
    return {"n_dofs": model.space.n_dofs, "n_colors": dn._topo[5],
            "n_pairs": int(len(dn._topo[0]) // 9),
            "escalated": driver.n_escalated, "accepted": s1.n_accepted,
            "rejected": s1.n_rejected, "t": s1.t, "dt": s1.dt,
            "factorizations": dn.n_factorizations,
            "direct_history": history_from(norms, per_step),
            "increment_norms": [float(np.linalg.norm(du[:, k]))
                                for k in range(3)],
            "host_s": time.perf_counter() - t0}


def port_rescue(ref: dict) -> dict:
    """The same advance with the port on the CPU, from its own moved
    state, and the control (the float32 residual in the line search)."""
    from fedm_tpu_torch.bagheri_run import build_models, parse_args
    from fedm_tpu_torch.solvers.direct import DirectNewton
    from fedm_tpu_torch.timestepping import AdaptiveDriver

    with tempfile.TemporaryDirectory() as tmp:
        args = parse_args(["--preset", "bagheri14", "--out", tmp,
                           "--device", "cpu"])
        model, _ = build_models(args, prw.window_corr(1e-2))
    moved = model.move_window(prw.window_corr(9.9e-3),
                              model.initial_state())
    base = model.system.newton
    out = {}
    for name, hi in (("port", True), ("control_f32_line_search", False)):
        model.system.newton = replace(base, **WEAK, hi_residual=hi)
        dn = DirectNewton(model.system, rtol=1e-3)
        histories = []
        step = dn.step

        def recorded_step(*a, step=step, dn=dn, histories=histories):
            res = step(*a)
            histories.append(list(dn.history))
            return res

        dn.step = recorded_step
        cfg = model.cfg
        driver = AdaptiveDriver(
            model.system, monitor_idx=1, ttol=cfg.ttol, dt_min=cfg.dt_min,
            dt_max=cfg.dt_max, post_accept=model.floor_projection(),
            fail_dt_cap=0.7, predictor=1.0, fallback_system=dn)
        t0 = time.perf_counter()
        s1 = driver.advance(moved)
        du = (s1.u - moved.u).numpy()
        got = {"n_colors": dn.n_colors, "n_pairs": dn.n_pairs,
               "escalated": driver.n_escalated, "accepted": s1.n_accepted,
               "rejected": s1.n_rejected, "t": s1.t, "dt": s1.dt,
               "factorizations": dn.n_factorizations,
               "direct_history": histories,
               "increment_norms": [float(np.linalg.norm(du[:, k]))
                                   for k in range(3)],
               "probe_s": dn.probe_s, "splu_s": dn.factor_s, "nnz": dn.nnz,
               "host_s": time.perf_counter() - t0}
        got["history_rel"] = [
            [abs(a - b) / b for a, b in zip(h, hr)]
            for h, hr in zip(got["direct_history"], ref["direct_history"])]
        got["increment_rel"] = [abs(a - b) / b for a, b in zip(
            got["increment_norms"], ref["increment_norms"])]
        out[name] = got
    model.system.newton = base
    return out


# -- options -----------------------------------------------------------------

def jax_options(tree: Path) -> dict:
    out = {"precond": {}, "advance": {}}
    for name, kw in OPTIONS.items():
        dtype = {"dtype": jnp.float32} if name.endswith("f32") else {}
        m = StreamerModel.from_file_input(tree, **kw, **dtype)
        if name == "mg":
            out["n_dofs"] = m.space.n_dofs
        s = m.initial_state()
        if name in PRECONDS:
            sys_ = m.system
            p = StepParams(jnp.asarray(s.dt), jnp.asarray(s.dt),
                           jnp.asarray(s.dt_old))
            args = sys_._cast_inputs(s.u, s.u, s.u_old1, {}, p)[:5]
            r, v = seeded(sys_.n_dofs)
            M = sys_.block_precond_builder(*args[1:])(args[0])
            out["precond"][name] = column_stats(M(jnp.asarray(r)), v)
            if name == "mg":
                out["row_weights"] = column_stats(
                    sys_._row_weights(*args), v)
        prw._JAX_COUNTS.clear()
        t0 = time.perf_counter()
        driver = m.make_driver()
        try:
            s1 = driver.advance(s, {})
            jax.effects_barrier()
            rec = {"accepted": s1.n_accepted, "rejected": s1.n_rejected,
                   "t": s1.t, "dt": s1.dt, "error": s1.max_error[0],
                   "exit": None}
        except SystemExit as exc:
            rec = {"exit": str(exc)}
        rec.update(iterations=dict(prw._JAX_COUNTS),
                   host_s=time.perf_counter() - t0)
        out["advance"][name] = rec
        print(f"# options {name}: {rec}", file=sys.stderr, flush=True)
        out.setdefault("spread", {})[name] = jax_spread(
            m, s, 1e-7 if name.endswith("f32") else 1e-12, rec)
        print(f"# spread {name}: {out['spread'][name]}", file=sys.stderr,
              flush=True)
    return out


def jax_spread(model, s, eps: float, rec: dict, seeds: int = 6) -> dict:
    """[min, max] of the Newton and BiCGStab counts of one advance from
    `s` scaled by (1 + eps * noise), over `seeds` seeded noises and the
    unperturbed advance `rec`."""
    import dataclasses

    newton, krylov = [rec["iterations"]["newton_iteration"]], [
        rec["iterations"].get("bicgstab", 0)]
    for seed in range(seeds):
        noise = np.random.default_rng(seed).standard_normal(s.u.shape)
        u = jnp.asarray(np.asarray(s.u) * (1 + eps * noise))
        prw._JAX_COUNTS.clear()
        model.make_driver().advance(dataclasses.replace(s, u=u), {})
        jax.effects_barrier()
        newton.append(prw._JAX_COUNTS["newton_iteration"])
        krylov.append(prw._JAX_COUNTS.get("bicgstab", 0))
    return {"eps": eps, "newton_iteration": [min(newton), max(newton)],
            "bicgstab": [min(krylov), max(krylov)]}


def port_options(tree: Path, ref: dict) -> dict:
    """The port on the CPU: its gaps to `ref`, its counts, and M r of the
    float32 model (the control)."""
    import torch
    from unittest import mock

    from fedm_tpu_torch.model.system import StepParams as PortParams
    from fedm_tpu_torch.models.streamer import StreamerModel as PortModel
    from fedm_tpu_torch.solvers import newton

    counts = {}

    def counting(name, fn):
        def run(*a, **kw):
            res = fn(*a, **kw)
            counts[name] = counts.get(name, 0) + (
                1 if name == "newton_iteration" else int(res[2]))
            return res

        return run

    patches = {n: counting(n, getattr(newton, n))
               for n in ("newton_iteration", "bicgstab", "gmres")}
    out = {"precond_rel": {}, "precond_f32_rel": {}, "advance": {}}
    for name, kw in OPTIONS.items():
        dtype = {"dtype": torch.float32} if name.endswith("f32") else {}
        m = PortModel.from_file_input(tree, device="cpu", **kw, **dtype)
        m.system.use_gather_scatter()
        s = m.initial_state()
        if name in PRECONDS:
            r, v = seeded(m.system.n_dofs)
            for key, dt in (("precond_rel", torch.float64),
                            ("precond_f32_rel", torch.float32)):
                mm = m if dt == torch.float64 else PortModel.from_file_input(
                    tree, device="cpu", dtype=torch.float32, **kw)
                ops = mm.system.operators(s.u, s.u_old1, PortParams(
                    s.dt, s.dt, s.dt_old))
                delta = torch.zeros_like(s.u, dtype=dt)
                M = mm.system.block_precond_builder(ops)(delta)
                out[key][name] = rel_gaps(
                    column_stats(M(torch.as_tensor(r, dtype=dt)).double(),
                                 v), ref["precond"][name])
                if name == "mg" and dt == torch.float64:
                    out["row_weights_rel"] = rel_gaps(column_stats(
                        mm.system.row_weights(ops, delta), v),
                        ref["row_weights"])
        counts.clear()
        t0 = time.perf_counter()
        with mock.patch.multiple(newton, **patches):
            try:
                s1 = m.make_driver().advance(s)
                rec = {"accepted": s1.n_accepted, "rejected": s1.n_rejected,
                       "t": s1.t, "dt": s1.dt, "error": s1.max_error[0],
                       "exit": None}
            except SystemExit as exc:
                rec = {"exit": str(exc)}
        rec.update(iterations=dict(counts), host_s=time.perf_counter() - t0)
        ref_rec = ref["advance"][name]
        if rec["exit"] is None and ref_rec["exit"] is None:
            rec["dt_rel"] = abs(rec["dt"] - ref_rec["dt"]) / ref_rec["dt"]
            rec["error_rel"] = (abs(rec["error"] - ref_rec["error"])
                                / ref_rec["error"])
        out["advance"][name] = rec
        print(f"# port options {name}: {rec}", file=sys.stderr, flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=["rescue", "options", "both"],
                    default="both")
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU and print its gaps")
    opts = ap.parse_args()
    # the JAX package's Newton and Krylov iterations, counted by host
    # callbacks (as tools/port_reference_window.py counts them)
    prw.count_jax_iterations()
    if opts.part in ("rescue", "both"):
        t0 = time.perf_counter()
        ref = jax_rescue()
        print(json.dumps({"rescue": ref}), flush=True)
        if opts.port:
            print(json.dumps({"rescue_port": port_rescue(ref)}), flush=True)
        print(f"# rescue part: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if opts.part in ("options", "both"):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            tree = write_tree(Path(tmp))
            ref = jax_options(tree)
            print(json.dumps({"options": ref}), flush=True)
            if opts.port:
                print(json.dumps({"options_port": port_options(tree, ref)}),
                      flush=True)
        print(f"# options part: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
