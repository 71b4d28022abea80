"""Where the time of the PyTorch port's adaptive advances goes, on the GPU.
One of three paths is set up, `--warmup` advances are run, and
`--advances` more are profiled under `torch.profiler`, one at a time:

- `restart`: the bench configuration (`bench.py:_stiff_bench`) restarted
  from bench_assets/bagheri_dz1e-5_ckpt.npz (484,155 unknowns);
- `window`: the Bagheri streamer at the `bagheri14` protocol of
  `python -m fedm_tpu_torch.bagheri_run` (30,305 dofs, the window at the
  seed) from t = 0, with the initial state (the Poisson solve) and one
  `move_window` timed first;
- `glow`: the argon glow discharge at the `glow50` protocol of
  `python -m fedm_tpu_torch.glow_run` (crossed 64 x 64 mesh, 41,605
  unknowns, the synthetic argon tree in a temporary directory) from t = 0,
  each advance with its per-advance coefficient update;
- `rescue`: the window's moved state, advanced by a primary Newton too
  weak to converge (max_iter 1, linear_maxiter 1), so that the driver
  escalates to `DirectNewton(rtol=1e-3)`, with its probing and `splu`
  host seconds (`chip_smoke.py`'s phase rescue);
- `options`: the JAX package's default StreamerConfig (graded 80 x 160,
  float64) with `--option` mg (the default), zline, tzline or
  row_scaled_f32, from t = 0 (`chip_smoke.py`'s phase options);
- `tof_1d`, `tof_2d`: the time-of-flight runs of `chip_smoke.py`'s phase
  tof (TimeOfFlight1D on 4,000 P2 cells, dt 1e-11; TimeOfFlight2D's
  reference configuration, dt 1e-12), an "advance" being one fixed-dt
  step, the first of them the BDF1 one.

Prints the card's name and power limit, then per profiled advance its
wall time, the device-busy time (the union of kernel intervals), the idle
share, the kernel count, K1's launches by wrapper, table and width and
its device time, then the kernels and operators that take the most
device time.

    python tools/torch_profile.py --path {restart,window,glow,rescue,options,
        tof_1d,tof_2d}
        [--option mg] [--warmup N] [--advances 1] [--top 25]
"""

import argparse
import collections
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fedm_tpu_torch.ops import ell_scatter as k1  # noqa: E402

# the window's third advance is a long Krylov solve (hundreds of BiCGStab
# and GMRES iterations): under the profiler it takes more than 6 minutes
WARMUP = {"restart": 1, "window": 0, "glow": 3, "rescue": 0, "options": 0,
          "tof_1d": 1, "tof_2d": 1}
# the options path's configurations (StreamerConfig overrides)
OPTIONS = {"mg": {}, "zline": {"poisson_precond": "zline"},
           "tzline": {"poisson_precond": "mg-zline", "transport_zline": True},
           "row_scaled_f32": {"row_scaled": True, "dtype": torch.float32}}


def busy_us(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def restart(tmp, option=None):
    """(state, advance): `advance(state)` takes one adaptive advance."""
    from fedm_tpu_torch.io import load_checkpoint
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.solvers.newton import NewtonConfig

    nc = NewtonConfig(rtol=1e-3, max_iter=20, linear_tol=3e-2,
                      linear_maxiter=400, accept_reduction=3e-2,
                      hi_residual=True, host_loop=True)
    cfg = StreamerConfig(dtype=torch.float32, newton=nc,
                         z_corridor=(0.0, 1.08e-2, 1e-5),
                         density_floor=1e13, r_corridor=(2e-3, 2e-5),
                         poisson_precond="mg-zline")
    model = StreamerModel(cfg, device="cuda")
    model.system.use_gather_scatter()
    state = load_checkpoint(ROOT / "bench_assets" / "bagheri_dz1e-5_ckpt.npz",
                            device="cuda")
    driver = model.make_driver(verbose=True)
    print(f"{model.space.n_dofs} dofs")
    return state, lambda s: driver.advance(s, {})


def _moved_window(tmp):
    """(args, model, fallback, state): the bagheri14 window at the seed,
    its initial state moved with the window, each step timed."""
    from fedm_tpu_torch.bagheri_run import (build_models, parse_args,
                                            window_corr)

    args = parse_args(["--preset", "bagheri14", "--out", tmp])
    model, fallback = build_models(
        args, window_corr(1e-2, args.window_span, args.window_dz))
    print(f"{model.space.n_dofs} dofs")
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = model.initial_state()
    torch.cuda.synchronize()
    print(f"initial state {time.perf_counter() - t:.3f} s (Poisson CG "
          f"{model.initial_poisson[1]} iterations, relres "
          f"{model.initial_poisson[0]:.2e})")
    t = time.perf_counter()
    state = model.move_window(
        window_corr(9.9e-3, args.window_span, args.window_dz), state)
    torch.cuda.synchronize()
    print(f"move_window {time.perf_counter() - t:.3f} s")
    return args, model, fallback, state


def window(tmp, option=None):
    from fedm_tpu_torch.bagheri_run import build_driver

    args, model, fallback, state = _moved_window(tmp)
    driver = build_driver(args, model, fallback)
    return state, lambda s: driver.advance(s, {})


def rescue(tmp, option=None):
    import dataclasses

    from fedm_tpu_torch.solvers.direct import DirectNewton
    from fedm_tpu_torch.timestepping import AdaptiveDriver

    _, model, _, state = _moved_window(tmp)
    sys_, cfg = model.system, model.cfg
    sys_.newton = dataclasses.replace(sys_.newton, max_iter=1,
                                      linear_maxiter=1, rtol=1e-10,
                                      accept_reduction=0.0, max_stalls=1)
    dn = DirectNewton(sys_, rtol=1e-3)
    driver = AdaptiveDriver(
        sys_, monitor_idx=1, ttol=cfg.ttol, dt_min=cfg.dt_min,
        dt_max=cfg.dt_max, post_accept=model.floor_projection(),
        fail_dt_cap=0.7, predictor=1.0, fallback_system=dn)

    def advance(s):
        s = driver.advance(s, {})
        print(f"direct rescue: {dn.n_factorizations} factorizations, "
              f"{dn.n_probes} probes in {dn.probe_s:.3f} s, splu "
              f"{dn.factor_s:.3f} s, nnz {dn.nnz}")
        return s

    return state, advance


def options(tmp, option="mg"):
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel

    model = StreamerModel(StreamerConfig(**OPTIONS[option]), device="cuda")
    model.system.use_gather_scatter()
    print(f"{model.space.n_dofs} dofs, option {option}")
    driver = model.make_driver(verbose=True)
    return model.initial_state(), lambda s: driver.advance(s, {})


def glow(tmp, option=None):
    from fedm_tpu_torch.glow_run import build_driver, build_models, parse_args

    args = parse_args(["--preset", "glow50", "--out", tmp])
    model, fallback = build_models(args)
    driver = build_driver(args, model, fallback)
    print(f"{model.space.n_dofs} dofs, {model.n_eq * model.space.n_dofs} "
          f"unknowns")
    return (model.initial_state(),
            lambda s: driver.advance(s, model._update_aux(s.u)))


def _tof(model):
    """(state, advance) of a ToF model: one fixed-dt step per advance,
    BDF1 first (dt_old = 1e30), as `_TofBase.run` steps."""
    import types

    from fedm_tpu_torch.model.system import StepParams

    c = model.cfg
    u0 = model.initial_state()
    print(f"{model.space.n_dofs} dofs")
    state = types.SimpleNamespace(u=u0, u_old=u0, t=c.t0, dt_old=1e30,
                                  n_accepted=0, n_rejected=0)

    def advance(s):
        t = s.t + c.dt
        u, info = model.system.step(s.u, s.u, s.u_old, {},
                                    StepParams(t, c.dt, s.dt_old))
        print(f"step to t = {t:.4e}: {info.iters} Newton iterations")
        return types.SimpleNamespace(u=u, u_old=s.u, t=t, dt_old=c.dt,
                                     n_accepted=s.n_accepted + 1,
                                     n_rejected=s.n_rejected)

    return state, advance


def tof_1d(tmp, option=None):
    from fedm_tpu_torch.models.tof import TimeOfFlight1D, TofConfig

    return _tof(TimeOfFlight1D(TofConfig(dt=1e-11, T_final=1e-10),
                               n_cells=4000))


def tof_2d(tmp, option=None):
    from fedm_tpu_torch.models.tof import TimeOfFlight2D

    return _tof(TimeOfFlight2D())


PATHS = {"restart": restart, "window": window, "glow": glow,
         "rescue": rescue, "options": options, "tof_1d": tof_1d,
         "tof_2d": tof_2d}


def main():
    ap = argparse.ArgumentParser(
        description="Profile adaptive advances of one of the port's paths "
                    "on the GPU.")
    ap.add_argument("--path", choices=sorted(PATHS), required=True)
    ap.add_argument("--warmup", type=int, default=None,
                    help="advances before the profiled ones (default: "
                         + ", ".join(f"{k} {v}" for k, v in WARMUP.items())
                         + ")")
    ap.add_argument("--option", choices=sorted(OPTIONS), default="mg",
                    help="the options path's configuration")
    ap.add_argument("--advances", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; path {opts.path}")
    warmup = WARMUP[opts.path] if opts.warmup is None else opts.warmup
    with tempfile.TemporaryDirectory() as tmp:
        state, advance = PATHS[opts.path](tmp, opts.option)
        for _ in range(warmup):
            state = advance(state)
        torch.cuda.synchronize()
        for _ in range(opts.advances):
            k1.LAUNCHES.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                acc, rej = state.n_accepted, state.n_rejected
                state = advance(state)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = busy_us(kernels) * 1e-6
            k1_events = [e for e in kernels if "ell_scatter" in e.name]
            k1_s = sum(e.time_range.end - e.time_range.start
                       for e in k1_events) * 1e-6
            shapes = collections.Counter()
            for (wrapper, table, C, dt), n in k1.LAUNCHES.items():
                shapes[f"{wrapper} {table} C={C} {dt}"] += n
            print(f"advance to t = {state.t:.4e}: wall {wall:.3f} s, device "
                  f"busy {busy:.3f} s, idle share {1 - busy / wall:.1%}, "
                  f"{len(kernels)} device kernels, accepted "
                  f"{state.n_accepted - acc}, rejected "
                  f"{state.n_rejected - rej}; K1 launches "
                  f"{dict(sorted(shapes.items()))}, {len(k1_events)} K1 "
                  f"kernels in the trace, {k1_s * 1e6:.1f} us of device time "
                  f"({k1_s / max(busy, 1e-12):.2e} of the busy time)")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                     row_limit=opts.top))


if __name__ == "__main__":
    main()
