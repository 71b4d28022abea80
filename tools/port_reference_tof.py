"""Reference numbers for the PyTorch port's time-of-flight smoke phase.

Runs, with the JAX package on the CPU in float64, the time-of-flight
verification models as `examples/tof_1d.py` and `examples/tof_2d.py`
build them:

  1d     TimeOfFlight1D(TofConfig(dt=1e-11, T_final=1e-10), n_cells=4000):
         4,000 P2 cells (8,001 dofs), 10 steps. The 2-norm of the initial
         state, the 2-norm of the float64 residual of the first step at
         delta = 0 (t = dt, BDF1: dt_old = 1e30), the Newton iterations of
         each step and the relative L2 error at 1e-10;
  2d     TimeOfFlight2D(): the reference configuration (40 x 40 P1,
         axisymmetric, dt 1e-12 over [2.5e-9, 2.6e-9], 100 steps). The
         Newton iterations of each step and the relative L2 errors at
         2.52e-9 (after 20 steps) and at 2.6e-9;
  quick  `examples/tof_1d.py --quick`'s model (400 cells, to 3e-10): the
         three relative L2 errors it writes to `relative error.log`.

Prints one JSON line, which `chip_smoke.py` holds the port to on the card.
With --port it then runs the same with the PyTorch port on the CPU and
prints a second JSON line: the port's relative gaps to those numbers, its
Newton counts, and the gaps of the controls the tolerances must refuse:
the initial state rounded to float32, the first residual evaluated in
float32, and each final state's error measured one step early (the
exact solution at T - dt).

    JAX_PLATFORMS=cpu python tools/port_reference_tof.py [--port]
        [--part 1d|2d|quick|all]

With --port the whole run takes about 7 minutes on a CPU with one torch
thread (OMP_NUM_THREADS=1; the port's 1D run ~3 minutes of it).
"""

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import fedm_tpu  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
from fedm_tpu.model.system import StepParams  # noqa: E402
from fedm_tpu.models.tof import (TimeOfFlight1D, TimeOfFlight2D,  # noqa: E402
                                 TofConfig)

CONFIGS = {
    "1d": dict(cls="1d", cfg=dict(dt=1e-11, T_final=1e-10),
               kw=dict(n_cells=4000), out=[1e-10]),
    "2d": dict(cls="2d", cfg=None, kw={}, out=[2.52e-9, 2.6e-9]),
    "quick": dict(cls="1d", cfg=dict(dt=1e-11, T_final=3e-10),
                  kw=dict(n_cells=400),
                  out=[k * 10 * 1e-11 for k in range(1, 4)]),
}


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def jax_model(part):
    c = CONFIGS[part]
    cls = TimeOfFlight1D if c["cls"] == "1d" else TimeOfFlight2D
    return cls(TofConfig(**c["cfg"]) if c["cfg"] else None, **c["kw"])


def jax_numbers(part) -> dict:
    m = jax_model(part)
    cfg = m.cfg
    out = {"n_dofs": m.space.n_dofs}
    u0 = m.initial_state()
    out["initial_state_norm"] = float(jnp.linalg.norm(u0))
    F = m.system.residual(u0, u0, u0, {}, StepParams(
        jnp.asarray(cfg.t0 + cfg.dt), jnp.asarray(cfg.dt),
        jnp.asarray(1e30)))
    out["initial_residual_norm"] = float(jnp.linalg.norm(F))
    iters = []
    step = m.system.step

    def counted(*a):
        res = step(*a)
        iters.append(int(res[1].iters))
        return res

    m.system.step = counted
    _, errors = m.run(output_times=CONFIGS[part]["out"])
    out["newton_iterations"] = iters
    out["errors"] = [[float(t), float(e)] for t, e in errors]
    return out


def port_numbers(part, ref) -> dict:
    import torch

    from fedm_tpu_torch.model.system import StepParams as TStepParams
    from fedm_tpu_torch.models.tof import TimeOfFlight1D as T1
    from fedm_tpu_torch.models.tof import TimeOfFlight2D as T2
    from fedm_tpu_torch.models.tof import TofConfig as TC

    c = CONFIGS[part]
    cls = T1 if c["cls"] == "1d" else T2
    m = cls(TC(**c["cfg"]) if c["cfg"] else None, **c["kw"], device="cpu")
    cfg = m.cfg
    out = {}
    u0 = m.initial_state()
    params = TStepParams(cfg.t0 + cfg.dt, cfg.dt, 1e30)
    norm = float(torch.linalg.vector_norm(u0))
    res = float(torch.linalg.vector_norm(m.system.residual(u0, u0, u0,
                                                           params)))
    out["initial_state_rel"] = _rel(norm, ref["initial_state_norm"])
    out["initial_residual_rel"] = _rel(res, ref["initial_residual_norm"])
    out["control_state_f32_rel"] = _rel(float(torch.linalg.vector_norm(
        u0.float().double())), ref["initial_state_norm"])
    out["control_residual_f32_rel"] = _rel(float(torch.linalg.vector_norm(
        m.system.residual(u0, u0, u0, params, torch.float32).double())),
        ref["initial_residual_norm"])
    u, errors = m.run(output_times=c["out"])
    out["newton_iterations"] = [int(i.iters) for i in m.step_infos]
    out["newton_iterations_equal"] = (out["newton_iterations"]
                                      == ref["newton_iterations"])
    out["errors"] = [[t, e] for t, e in errors]
    out["error_rel"] = [_rel(e, r[1]) for (_, e), r in zip(errors,
                                                           ref["errors"])]
    t_end = errors[-1][0]
    out["control_error_one_step_early_rel"] = _rel(
        m.relative_l2_error(u, t_end - cfg.dt), ref["errors"][-1][1])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--part", choices=("1d", "2d", "quick", "all"),
                    default="all")
    args = ap.parse_args()
    parts = list(CONFIGS) if args.part == "all" else [args.part]
    ref = {p: jax_numbers(p) for p in parts}
    print(json.dumps(ref), flush=True)
    if args.port:
        print(json.dumps({p: port_numbers(p, ref[p]) for p in parts}),
              flush=True)


if __name__ == "__main__":
    main()
