"""Reference numbers for the PyTorch port's moving-window smoke phase.

Builds, with the JAX package on the CPU, the Bagheri streamer at the
`bagheri14` protocol of `tools/bagheri_run.py` (float32 compute with the
float64 defect, the window at the seed: corridor window_corr(1e-2) at
dz = 1e-5, tails (10, 48), r-corridor (2e-3, 2e-5), no stabilisation),
then:

  1. its initial state: the state's per-column 2-norms and the
     per-equation 2-norms of the float64 residual of the first attempted
     step (delta = 0, dt = dt_init);
  2. the window moved to window_corr(9.9e-3) with the initial state
     remapped: the remapped state's per-column 2-norms and the float64
     residual's per-equation 2-norms there.

Prints one JSON line, which `chip_smoke.py` holds the port to on the card.
With --port it then runs the same steps with the PyTorch port on the CPU,
from its own initial state, and prints a second JSON line: the port's
relative gaps to those numbers, its Poisson CG iterations, the host
seconds of its initial state and of `move_window` on this CPU, and the
gaps of the port's residual evaluated in float32 (no float64 defect), a
lower-precision result that `chip_smoke.py`'s residual tolerances must
refuse.

With --port --advances N each package then takes N adaptive advances with
the `bagheri14` driver (predictor 1.0, fail-dt cap 0.7, true-residual
rescue, no fallback system) from its own moved state and again from the
other package's, and each advance prints one JSON line: the package, the
package whose moved state it started from, dt and t, the accepted and
rejected counts, and the Newton iterations (a rescued iteration counts
twice) and BiCGStab and GMRES iterations it took, counted as
`chip_smoke.py` counts them on the card. Before each advance of the JAX
package from its own state, the port also takes one advance from that
same state. The crossed runs tell a port fault (the port differs from
the JAX package on the same state) from the problem's own sensitivity
(both packages change alike with the state).

With --perturb EPS... the JAX package takes one advance from its moved
state and then its second advance again from that state with u scaled
by (1 + EPS * noise) for each EPS, one JSON line each; with
--perturb-advance 1 it takes instead its first advance from the moved
state so scaled (the spread `chip_smoke.py` phase 12 holds the window's
first advance on z-slabs to).

    JAX_PLATFORMS=cpu python tools/port_reference_window.py [--port] \
        [--advances N] [--perturb EPS ...] [--perturb-advance 1|2]
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import fedm_tpu  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
from fedm_tpu.model.system import StepParams  # noqa: E402
from fedm_tpu.models.streamer import StreamerConfig, StreamerModel  # noqa: E402
from fedm_tpu.solvers.newton import NewtonConfig  # noqa: E402

SPAN, DZ = 1.5e-3, 1e-5


def window_corr(front):
    """`tools/bagheri_run.py`'s window placement (60 % of the span ahead
    of the front, clamped to [1e-4, 1.19e-2])."""
    z_lo, z_hi = front - 0.6 * SPAN, front + 0.4 * SPAN
    if z_hi > 1.19e-2:
        z_lo, z_hi = 1.19e-2 - SPAN, 1.19e-2
    if z_lo < 1e-4:
        z_lo, z_hi = 1e-4, 1e-4 + SPAN
    return (z_lo, z_hi, DZ)


def residual_norms(model, s):
    params = StepParams(jnp.asarray(s.t + s.dt), jnp.asarray(s.dt),
                        jnp.asarray(s.dt_old))
    R = model.system._make_hi_residual(s.u, s.u_old, {}, params)
    F = np.asarray(R(jnp.zeros(s.u.shape, jnp.float32)))
    return [float(np.linalg.norm(F[:, k])) for k in range(F.shape[1])]


def column_norms(u):
    u = np.asarray(u)
    return [float(np.linalg.norm(u[:, k])) for k in range(u.shape[1])]


def advance_record(pkg, origin, k, state, counts, t0):
    return {"package": pkg, "from": origin, "advance": k,
            "dt": float(state.dt), "t": float(state.t),
            "accepted": int(state.n_accepted),
            "rejected": int(state.n_rejected), "iterations": dict(counts),
            "host_s": time.perf_counter() - t0}


_JAX_COUNTS = {}


def count_jax_iterations() -> None:
    """Wrap the JAX package's solver functions, before their first trace,
    in host callbacks that add each execution's Newton iteration (one per
    call: a rescued iteration counts twice) or Krylov iterations to
    `_JAX_COUNTS`."""
    import jax

    from fedm_tpu.solvers import newton

    if getattr(newton, "_counted", False):
        return
    newton._counted = True

    def counting(name, fn):
        def bump(k):
            _JAX_COUNTS[name] = _JAX_COUNTS.get(name, 0) + int(k)

        def run(*args, **kw):
            out = fn(*args, **kw)
            jax.debug.callback(bump, 1 if name == "newton_iteration"
                               else out[2])
            return out

        return run

    for name in ("newton_iteration", "bicgstab", "gmres"):
        setattr(newton, name, counting(name, getattr(newton, name)))


def jax_advances(model, s, n: int, origin: str, port_model=None) -> None:
    """`n` advances of the JAX package from `s` with the `bagheri14`
    driver settings, one JSON line each. With `port_model`, the port first
    takes one advance from the same state before each of them (its line
    says "from": "same state")."""
    import jax

    from fedm_tpu.timestepping import AdaptiveDriver

    driver = AdaptiveDriver(
        model.system, monitor_idx=1, ttol=model.cfg.ttol,
        dt_min=model.cfg.dt_min, dt_max=model.cfg.dt_max,
        post_accept=model.floor_projection(), fail_dt_cap=0.7,
        predictor=1.0)
    for k in range(n):
        if port_model is not None:
            port_advances(port_model, swap_state(s, to_port=True), 1,
                          "same state", first=k + 1)
        _JAX_COUNTS.clear()
        t0 = time.perf_counter()
        s = driver.advance(s, {})
        jax.effects_barrier()
        print(json.dumps(advance_record("jax", origin, k + 1, s,
                                        _JAX_COUNTS, t0)), flush=True)


def port_advances(model, s, n: int, origin: str, first: int = 1) -> None:
    """`n` advances of the port from `s` through the entry point's
    driver, one JSON line each, counted as `chip_smoke.py` counts them."""
    import tempfile
    from unittest import mock

    from fedm_tpu_torch.bagheri_run import build_driver, parse_args
    from fedm_tpu_torch.solvers import newton

    counts = {}

    def counting(name, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            counts[name] = counts.get(name, 0) + (
                1 if name == "newton_iteration" else int(out[2]))
            return out

        return run

    patches = {name: counting(name, getattr(newton, name))
               for name in ("newton_iteration", "bicgstab", "gmres")}
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.multiple(newton, **patches):
        args = parse_args(["--preset", "bagheri14", "--no-direct-rescue",
                           "--out", tmp, "--device", "cpu"])
        driver = build_driver(args, model)
        for k in range(n):
            counts.clear()
            t0 = time.perf_counter()
            s = driver.advance(s, {})
            print(json.dumps(advance_record("port", origin, first + k, s,
                                            counts, t0)), flush=True)


def jax_perturbed(model, s, eps_list, advance: int = 2) -> None:
    """One JAX advance from `s`, then the second advance again from that
    state with u scaled by (1 + eps * noise) for each eps (standard normal
    noise from one seeded generator), one JSON line each: how far the
    reference's own iteration counts move under perturbations far below
    the gaps between the two packages' states. With `advance` 1 the first
    advance, from `s` so scaled."""
    import dataclasses

    import jax

    from fedm_tpu.timestepping import AdaptiveDriver

    def driver():
        return AdaptiveDriver(
            model.system, monitor_idx=1, ttol=model.cfg.ttol,
            dt_min=model.cfg.dt_min, dt_max=model.cfg.dt_max,
            post_accept=model.floor_projection(), fail_dt_cap=0.7,
            predictor=1.0)

    s1 = driver().advance(s, {}) if advance == 2 else s
    rng = np.random.default_rng(0)
    for eps in eps_list:
        u = np.asarray(s1.u) * (1 + eps * rng.standard_normal(s1.u.shape))
        _JAX_COUNTS.clear()
        t0 = time.perf_counter()
        out = driver().advance(dataclasses.replace(s1, u=jnp.asarray(u)), {})
        jax.effects_barrier()
        rec = advance_record("jax", "jax, perturbed", advance, out,
                             _JAX_COUNTS, t0)
        print(json.dumps({"eps": eps, **rec}), flush=True)


def swap_state(s, to_port: bool):
    """The TimeState `s` of one package as the other package's."""
    if to_port:
        import torch

        from fedm_tpu_torch.timestepping.driver import TimeState

        def arr(a):
            return torch.as_tensor(np.array(a))
    else:
        from fedm_tpu.timestepping.driver import TimeState

        def arr(a):
            return jnp.asarray(a.cpu().numpy())
    return TimeState(arr(s.u), arr(s.u_old), arr(s.u_old1), float(s.t),
                     float(s.dt), float(s.dt_old),
                     [float(x) for x in s.max_error], int(s.n_accepted),
                     int(s.n_rejected))


def port_gaps(ref: dict):
    """The port on the CPU through the same steps: relative gaps to the
    JAX numbers in `ref`, and its host times. Returns (gaps, model,
    moved state)."""
    import tempfile

    import torch

    from fedm_tpu_torch.bagheri_run import build_models, parse_args
    from fedm_tpu_torch.model.system import StepParams as PortParams

    def norms(x):
        return [float(torch.linalg.vector_norm(x[:, k]))
                for k in range(x.shape[1])]

    def residual(model, s, dtype=torch.float64):
        F = model.system.residual(s.u, s.u, s.u_old,
                                  PortParams(s.t + s.dt, s.dt, s.dt_old),
                                  dtype)
        return norms(F.double())

    def rel(got, key):
        return [abs(a - b) / abs(b) for a, b in zip(got, ref[key])]

    with tempfile.TemporaryDirectory() as tmp:
        args = parse_args(["--preset", "bagheri14", "--no-direct-rescue",
                           "--out", tmp, "--device", "cpu"])
        model, _ = build_models(args, tuple(ref["corridor"]))
    t = time.perf_counter()
    s = model.initial_state()
    out = {"initial_state_s": time.perf_counter() - t,
           "poisson_iters": model.initial_poisson[1],
           "initial_state_rel": rel(norms(s.u), "initial_state_norms"),
           "initial_residual_rel": rel(residual(model, s),
                                       "initial_residual_norms"),
           "initial_residual_f32_rel": rel(residual(model, s, torch.float32),
                                           "initial_residual_norms")}
    t = time.perf_counter()
    s = model.move_window(tuple(ref["moved_to"]), s)
    out.update({"move_window_s": time.perf_counter() - t,
                "moved_state_rel": rel(norms(s.u), "moved_state_norms"),
                "moved_residual_rel": rel(residual(model, s),
                                          "moved_residual_norms"),
                "moved_residual_f32_rel": rel(
                    residual(model, s, torch.float32),
                    "moved_residual_norms")})
    return out, model, s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU and print its gaps")
    ap.add_argument("--perturb", type=float, nargs="+", default=None,
                    help="then the JAX package's second advance from its "
                         "own state perturbed by each of these relative "
                         "sizes")
    ap.add_argument("--perturb-advance", type=int, default=2,
                    choices=[1, 2],
                    help="with --perturb: the advance that starts from the "
                         "perturbed state")
    ap.add_argument("--advances", type=int, default=0,
                    help="with --port: then take this many advances in "
                         "each package from each moved state")
    opts = ap.parse_args()
    nc = NewtonConfig(rtol=1e-3, max_iter=20, linear_tol=1e-2,
                      linear_maxiter=400, accept_reduction=3e-2,
                      host_loop=True, hi_residual=True, true_res_rescue=1.0)
    cfg = StreamerConfig(dtype=jnp.float32, newton=nc, nx=96,
                         z_corridor=window_corr(1e-2), z_tail_cells=(10, 48),
                         r_corridor=(2e-3, 2e-5), stab_mode="off",
                         poisson_precond="mg-zline", density_floor=1e13)
    model = StreamerModel(cfg)
    model.system.use_gather_scatter()
    model.system.enable_geom_mode()
    s = model.initial_state()
    out = {"n_dofs": model.space.n_dofs,
           "corridor": list(cfg.z_corridor),
           "initial_state_norms": column_norms(s.u),
           "initial_residual_norms": residual_norms(model, s)}
    moved_to = window_corr(9.9e-3)
    s = model.move_window(moved_to, s)
    moved = s
    out.update({"moved_to": list(moved_to),
                "moved_state_norms": column_norms(s.u),
                "moved_residual_norms": residual_norms(model, s)})
    print(json.dumps(out), flush=True)
    if opts.perturb:
        count_jax_iterations()
        jax_perturbed(model, moved, opts.perturb, opts.perturb_advance)
    if not opts.port:
        return
    gaps, port_model, port_moved = port_gaps(out)
    print(json.dumps(gaps), flush=True)
    if opts.advances:
        n = opts.advances
        count_jax_iterations()
        port_advances(port_model, port_moved, n, "port")
        port_advances(port_model, swap_state(moved, to_port=True), n, "jax")
        jax_advances(model, moved, n, "jax", port_model)
        jax_advances(model, swap_state(port_moved, to_port=False), n,
                     "port")


if __name__ == "__main__":
    main()
