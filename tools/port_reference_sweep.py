"""Reference numbers for the PyTorch port's `9 sweep` smoke phase.

Runs, with the JAX package on the CPU, a batched sweep (`BatchedSweep`) of
the default `StreamerConfig` (graded 80 x 160, 13,041 dofs, float64,
poisson_precond "mg") over B = 8 members whose seed amplitudes are
`np.geomspace(1e18, 2e19, 8)`: the members' initial states, the first
attempt's Newton iterations per member (one extra vmapped step from the
stacked initial states), then 3 lockstep attempts and `run_until` a
horizon of 2e-11, and prints one JSON line:

  initial    per member, the per-column 2-norms of the initial state;
  first      per member, the first attempt's converged flag and Newton
             iterations;
  attempts   after each attempt, per member: n_accepted, n_rejected, t,
             dt, max_error and the per-column 2-norms of u;
  run_until  the same after `run_until`, with the attempts it made.

With --port it then runs the port's `BatchedSweep` on the CPU from the
JAX package's initial states (moved with `convert.sweep_state_from_arrays`)
and prints a second JSON line: the gaps to those numbers (the largest
relative gap over the members of each quantity), the same gaps of the
control after the attempts (the same batch solved by one Newton-BiCGStab
over the stacked block-diagonal system, with its scalars and norms shared
across members),
each member's first attempt against the port's own single-system `step`
from the same state at the same parameters (Newton iterations and the
state's gap), and the gaps of the port's own initial states.

With --spread N it prints, between the two, the JAX package's own gaps
when its sweep starts from the initial states scaled by (1 + 1e-15 *
seeded noise), for N seeds: the step error is a ratio of small
differences, so over `run_until`'s 56 attempts the members' rounding
reaches max_error and dt far above it.

    JAX_PLATFORMS=cpu python tools/port_reference_sweep.py [--port]
        [--spread N] [--nx 80 --ny 160] [--amps 2e18,5e18,1e19]
        [--attempts 3] [--horizon 2e-11]
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import fedm_tpu  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
from fedm_tpu.model.system import StepParams as JaxParams  # noqa: E402
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig  # noqa: E402
from fedm_tpu.models.streamer import StreamerModel as JaxModel  # noqa: E402
from fedm_tpu.parallel import BatchedSweep as JaxSweep  # noqa: E402

AMPS = np.geomspace(1e18, 2e19, 8)


def col_norms(u) -> list:
    """Per member, the per-column 2-norms of u [B, n_dofs, n_eq]."""
    u = np.asarray(u, np.float64)
    return np.sqrt((u * u).sum(axis=1)).tolist()


def record(st) -> dict:
    return {"n_accepted": np.asarray(st.n_accepted).tolist(),
            "n_rejected": np.asarray(st.n_rejected).tolist(),
            "t": np.asarray(st.t, np.float64).tolist(),
            "dt": np.asarray(st.dt, np.float64).tolist(),
            "max_error": np.asarray(st.max_error, np.float64).tolist(),
            "u_norms": col_norms(st.u)}


def jax_spread(states, nx, ny, attempts, horizon, ref, eps, seeds):
    """The JAX package's own sweep from its initial states scaled by
    (1 + eps * noise), per seeded noise: the largest gaps to the
    unperturbed run `ref` after the attempts and after `run_until` (the
    range a port that rounds differently may land in)."""
    cfg = JaxConfig(nx=nx, ny=ny)
    sw = JaxSweep(JaxModel(cfg).system, monitor_idx=1, ttol=cfg.ttol,
                  dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    out = []
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        pert = [dataclasses.replace(s, u=jnp.asarray(np.asarray(s.u) * (
            1 + eps * rng.standard_normal(s.u.shape)))) for s in states]
        st = sw.from_states(pert)
        for _ in range(attempts):
            st = sw.attempt(st, {})
        rec = {"attempts": gaps(record(st), ref["attempts"][-1])}
        st = sw.run_until(st, horizon, {})
        rec["run_until"] = gaps(record(st), ref["run_until"])
        out.append(rec)
    return {"eps": eps, "seeds": out}


def jax_numbers(nx, ny, amps, attempts, horizon):
    cfg = JaxConfig(nx=nx, ny=ny)
    model = JaxModel(cfg)
    states = [JaxModel(dataclasses.replace(cfg, seed_amplitude=a))
              .initial_state() for a in amps]
    sw = JaxSweep(model.system, monitor_idx=1, ttol=cfg.ttol,
                  dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    st = sw.from_states(states)
    out = {"config": {"nx": nx, "ny": ny, "amps": list(map(float, amps)),
                      "attempts": attempts, "horizon": horizon,
                      "dofs": int(st.u.shape[1]),
                      "unknowns_per_member": int(st.u.shape[1]
                                                 * st.u.shape[2])},
           "initial": col_norms(st.u)}
    params = JaxParams(jnp.asarray(st.t + st.dt), jnp.asarray(st.dt),
                       jnp.asarray(st.dt_old))
    _, info = sw._vstep(st.u, st.u, st.u_old1, {}, params)
    out["first"] = {"converged": np.asarray(info.converged).tolist(),
                    "newton_iterations": np.asarray(info.iters).tolist()}
    out["attempts"] = []
    t0 = time.perf_counter()
    for _ in range(attempts):
        st = sw.attempt(st, {})
        out["attempts"].append(record(st))
    n0 = st.n_accepted + st.n_rejected
    st = sw.run_until(st, horizon, {})
    out["run_until"] = record(st)
    out["run_until"]["attempts"] = int(
        (st.n_accepted + st.n_rejected - n0).max())
    out["jax_cpu_s"] = time.perf_counter() - t0
    return out, states


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.where(b == 0, 1.0, np.abs(b))))


def gaps(rec, ref) -> dict:
    out = {k: rec[k] == ref[k] for k in ("n_accepted", "n_rejected")}
    out.update({k: _gap(rec[k], ref[k])
                for k in ("t", "dt", "max_error", "u_norms")})
    return out


def shared_scalars():
    """The control: `newton_krylov_batched` replaced by the single-system
    `newton_krylov` over the stacked [B, n_dofs, n_eq] vectors, so every
    dot, norm and stopping test is shared by the members."""
    from fedm_tpu_torch.solvers.newton import NewtonInfo, newton_krylov

    def solve(residual, jac, delta, config, pb, residual_hi=None,
              active=None):
        d, info = newton_krylov(residual, jac, delta, config, pb,
                                residual_hi)
        return d, NewtonInfo(*(np.full(delta.shape[0], x) for x in info))

    return solve


def port_numbers(ref, jax_states, nx, ny, amps, attempts, horizon):
    from unittest import mock

    import fedm_tpu_torch.model.system as tsys
    from fedm_tpu_torch.convert import (state_to_arrays,
                                        sweep_state_from_arrays)
    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.parallel import BatchedSweep

    cfg = StreamerConfig(nx=nx, ny=ny)
    model = StreamerModel(cfg, device="cpu")
    sw = BatchedSweep(model.system, monitor_idx=1, ttol=cfg.ttol,
                      dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    arrays = [{k: np.asarray(getattr(s, k)) for k in
               ("u", "u_old", "u_old1", "t", "dt", "dt_old", "max_error",
                "n_accepted", "n_rejected")} for s in jax_states]
    out = {}
    own = [StreamerModel(dataclasses.replace(cfg, seed_amplitude=a),
                         device="cpu").initial_state() for a in amps]
    out["own_initial_gap"] = _gap(col_norms(np.stack(
        [state_to_arrays(s)["u"] for s in own])), ref["initial"])

    def run(ctx):
        st = sweep_state_from_arrays(arrays, device="cpu")
        recs = []
        with ctx:
            t0 = time.perf_counter()
            for _ in range(attempts):
                st = sw.attempt(st, {})
                recs.append(record(st))
            st = sw.run_until(st, horizon, {})
            wall = time.perf_counter() - t0
        return st, recs, record(st), wall

    st0 = sweep_state_from_arrays(arrays, device="cpu")
    out["from_arrays_gap"] = _gap(col_norms(st0.u), ref["initial"])
    # each member's first attempt, batched and single
    params = StepParams(st0.t + st0.dt, st0.dt, st0.dt_old)
    u_b, info_b = sw.batched(len(amps)).step(st0.u, st0.u, st0.u_old1, {},
                                            params)
    singles = []
    for b in range(len(amps)):
        u_s, info_s = model.system.step(
            st0.u[b], st0.u[b], st0.u_old1[b], {},
            StepParams(*(float(x[b]) for x in params)))
        scale = u_s.abs().amax(dim=0)
        singles.append({
            "newton_batched": int(info_b.iters[b]),
            "newton_single": int(info_s.iters),
            "state_gap": float(((u_b[b] - u_s).abs().amax(dim=0)
                                / scale).max())})
    out["first_vs_single"] = singles
    out["first_newton"] = np.asarray(info_b.iters).tolist()
    _, recs, fin, wall = run(contextlib.nullcontext())
    out["attempts"] = [gaps(r, q) for r, q in zip(recs, ref["attempts"])]
    out["run_until"] = gaps(fin, ref["run_until"])
    out["port_cpu_s"] = wall
    st = sweep_state_from_arrays(arrays, device="cpu")
    with mock.patch.object(tsys, "newton_krylov_batched", shared_scalars()):
        for _ in range(attempts):
            st = sw.attempt(st, {})
    out["control"] = gaps(record(st), ref["attempts"][-1])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--nx", type=int, default=80)
    ap.add_argument("--ny", type=int, default=160)
    ap.add_argument("--amps", default=None,
                    help="comma-separated seed amplitudes (default: "
                         "geomspace(1e18, 2e19, 8))")
    ap.add_argument("--attempts", type=int, default=3)
    ap.add_argument("--horizon", type=float, default=2e-11)
    ap.add_argument("--spread", type=int, default=0, metavar="SEEDS",
                    help="also the JAX sweep from SEEDS perturbed initial "
                         "states (1e-15 relative)")
    args = ap.parse_args()
    amps = (AMPS if args.amps is None
            else np.array([float(a) for a in args.amps.split(",")]))
    ref, states = jax_numbers(args.nx, args.ny, amps, args.attempts,
                              args.horizon)
    print(json.dumps(ref), flush=True)
    if args.spread:
        print(json.dumps({"spread": jax_spread(
            states, args.nx, args.ny, args.attempts, args.horizon, ref,
            1e-15, args.spread)}), flush=True)
    if args.port:
        print(json.dumps(port_numbers(ref, states, args.nx, args.ny, amps,
                                      args.attempts, args.horizon)),
              flush=True)


if __name__ == "__main__":
    main()
