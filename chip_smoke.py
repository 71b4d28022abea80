"""Smoke test of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version, and drives the port's
main path — the Bagheri streamer restart that `bench.py` times — at full size.

    python3 chip_smoke.py

Phases (each reports its elapsed seconds on stderr):
  0. device: a CUDA device must be present, else exit 1 with no result;
  1. build the ELL gather-sum kernel (K1) with nvcc;
  2. K1 against its plain version, float32 and float64: the dense form at
     the main path's facet shape and at the full-mesh cell shape, then
     device times with L2 flushed before every call (and warm, as an
     extra); the
     compact form (out[rows] += ..., the one the main path runs) at the
     facet shape, timed cold and warm beside its plain version, in-place
     `index_add_`, the dense path it replaced (out + dense scatter) and an
     empty kernel (the floor of a launch);
  3. the main path: the bench configuration restarted from
     bench_assets/bagheri_dz1e-5_ckpt.npz (484,155 unknowns), its float64
     residual held to the JAX package's norms, K1 against the plain scatter
     inside that residual, then 1 warm-up + 3 timed adaptive advances with
     K1's launch counter reset just before and read just after;
  4. the fresh window: the Bagheri streamer at the `bagheri14` protocol of
     `python -m fedm_tpu_torch.bagheri_run` (30,305 dofs, the moving window
     at the seed) started from t = 0: the initial Poisson solve, the
     initial state and first residual held to the JAX package's numbers
     (tools/port_reference_window.py), the window moved and the remapped
     state and its residual held to them too, K1 inside the moved
     residual against its plain version (exactly), then 10 adaptive
     advances with K1's launch counter reset just before and read just
     after;
  5. the glow: the argon glow discharge at the `glow50` protocol of
     `python -m fedm_tpu_torch.glow_run` (crossed 64 x 64 mesh, 8,321
     dofs, 41,605 unknowns, the synthetic argon tree generated into a
     temporary directory) from t = 0: the initial state, its first float64
     residual, and at a probe state the per-advance coefficients and the
     float64 residual, each held to the JAX package's numbers
     (tools/port_reference_glow.py), each residual tolerance shown to
     refuse the residual evaluated in float32; K1 inside the probe
     residual against the plain scatter; then 10 adaptive advances with
     K1's launch counter reset just before and read just after, which must
     show launches of K1's dense form (the unstructured cell scatter).
Phase 2 also holds and times K1 at the glow's shapes: the dense cell table
of the crossed 64 x 64 mesh (8,321 rows x 8 slots) at C = 1 (`project`),
5 (residual and Jacobian action, float32 and the float64 defect) and 25
(node blocks).
The script stops with a non-zero exit if any check fails or the whole run
passes its time budget. Its last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import collections
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

from fedm_tpu_torch import devtime
from fedm_tpu_torch.devtime import (HBM_BYTES_PER_S, device_ms, eager_ms,
                                    event_ms, l2_flush)

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "bench_assets" / "bagheri_dz1e-5_ckpt.npz"
BUDGET_S = 600          # the whole run; a healthy run takes far less
N_TIMED_ADVANCES = 3
# Per-equation 2-norms of the float64 residual at the checkpoint state
# (first attempt of the restart, delta = 0), computed with the JAX package
# on the CPU by:  JAX_PLATFORMS=cpu python tools/port_reference_norms.py
REF_RESIDUAL_NORMS = (4.148295764358092e+17, 3.539466381528627e+17,
                      0.0006266210202779736)
REF_RTOL = 1e-10
# The fresh window's reference numbers, computed with the JAX package on the
# CPU by:  JAX_PLATFORMS=cpu python tools/port_reference_window.py
# (per-column 2-norms of the state u = [ln n_ion, ln n_e, phi], and
# per-equation 2-norms of the float64 residual of the first attempted step)
REF_WINDOW = {
    "n_dofs": 30305,
    "corridor": (0.0091, 0.0106, 1e-05),
    "initial_state_norms": (5804.406627118043, 5210.941350488422,
                            2898662.183374749),
    "initial_residual_norms": (149990795867359.16, 150105563506790.22,
                               0.021438900084583566),
    "moved_to": (0.009000000000000001, 0.0105, 1e-05),
    "moved_state_norms": (5799.180214326058, 5210.941350488422,
                          2875121.699916858),
    "moved_residual_norms": (148300751466995.06, 148415166893003.0,
                             0.11401860614749627)}
# Relative tolerances per column / equation, each a few times the gap the
# port showed on the H100 (and within that of its gap on the CPU, by the
# same script with --port). The log-densities are the same closed form
# (1e-12: the norm's summation order). The potential comes from a
# float32-preconditioned CG stopped at relres 1e-6, so it agrees only to the
# rounding of that solve (H100 9.6e-11, CPU 5.2e-11). The electron row reads
# exp(-2.73e7/E) and so magnifies the field's difference ~20x (H100 5.0e-9,
# CPU 4.8e-9); the ion row much less (H100 1.0e-11, CPU 2.2e-11). The
# potential row at the initial state is the CG's final residual itself,
# whose size below its stopping target is set by rounding (H100 2.9e-4, CPU
# 7.4e-4); after the move it is mostly the interpolation's (H100 9.9e-6,
# CPU 2.5e-5). The same residual evaluated in float32 (no float64 defect)
# is off by 1.2e-6 or more in every row (CPU); the phase checks that it
# fails these tolerances, so they can tell the defect's precision apart.
WINDOW_STATE_RTOL = (1e-12, 1e-12, 5e-10)
WINDOW_INITIAL_RESIDUAL_RTOL = (5e-11, 2e-8, 2e-3)
WINDOW_MOVED_RESIDUAL_RTOL = (5e-11, 2e-8, 5e-5)
N_WINDOW_ADVANCES = 10
# The glow's reference numbers, computed with the JAX package on the CPU by:
#   JAX_PLATFORMS=cpu python tools/port_reference_glow.py
# (per-column 2-norms of the state u = [ln w_e, ln n_Ar*, ln n_Ar+, ln n_e,
# Phi]; per-equation 2-norms of the float64 residual of the first attempted
# step; at the probe state, per-column 2-norms of the coefficients and the
# per-equation 2-norms of the float64 residual of a step from it)
REF_GLOW = {
    "n_dofs": 8321,
    "initial_state_norms": (2620.703238391496, 2520.488357745355,
                            2520.488357745355, 2520.488357745355, 0.0),
    "initial_residual_norms": (66690746174683.47, 666981792298.5844,
                               180821484853.50662, 16231095409994.104,
                               0.2015463662212001),
    "probe_aux_norms": {
        "redE": (81968.13887211459,),
        "k": (4.601865958856485e-14, 1.226292816285291e-14,
              8.8432064401588e-14, 3.193913224339429e-13,
              5.6556099582626906e-14, 28688537.610864725,
              1.0014168347171087e-15),
        "mu": (0.0, 0.0, 6.49143439318578, 21423.499846467243),
        "D": (0.0, 0.6858247945741875, 0.16781650358536507,
              42843.44223478961)},
    "probe_residual_norms": (1.2312516476202338e+16, 758949839140.0553,
                             199220659412.83127, 824591448104785.5,
                             2013.5498899205277)}
# Relative tolerances, each a few times the gap the port showed in the
# glow phase of this script on one H100 (NVIDIA H100 80GB HBM3, 700 W; three
# runs read the same). The state is built in float64 from the same closed
# form: the gaps are the norms' summation order (H100 1.6e-15; the port's
# norms on the CPU 9.7e-14, another order). The residuals' rows are
# float64 sums of terms that cancel, in another order; at the probe state
# the reduced field comes from a float32 CG (`project`), which rounds
# differently (H100 and CPU 2.0e-8), and the ion mobility, diffusivity and
# the ion row (the third) read it. Per row (energy, Ar*, Ar+, e, Phi), the
# float64 gap, the limit, and the gap of the float32 control (the same
# residual evaluated in float32, no float64 defect), which the phase
# checks each limit refuses:
#   initial  1.1e-13 2e-16 8e-16 2.2e-14 0       (H100; CPU 1.1e-13 3.7e-16
#                                                5.1e-16 2.2e-14 0)
#   limit    5e-13   2e-15 4e-15 1e-13   1e-15
#   control  3.0e-7  4.0e-6 6.3e-6 3.6e-7 2.0e-8
#   probe    2.4e-13 0     2.9e-9 3.2e-12 2.3e-16
#   limit    1e-12   1e-15 1e-8  1e-11   1e-15
#   control  6.6e-7  9.5e-7 3.7e-7 8.1e-7 1.2e-8
# The closest pair is the probe's ion row: 3.5x above its gap, 37x below
# its control.
GLOW_PROBE_PARAMS = (1e-12, 1e-12, 1e30)  # t, dt, dt_old: a BDF1 step
GLOW_STATE_RTOL = (1e-14,) * 5
GLOW_INITIAL_RESIDUAL_RTOL = (5e-13, 2e-15, 4e-15, 1e-13, 1e-15)
GLOW_AUX_RTOL = {"redE": 1e-7, "k": 1e-14, "mu": 1e-8, "D": 1e-8}
GLOW_PROBE_RESIDUAL_RTOL = (1e-12, 1e-15, 1e-8, 1e-11, 1e-15)
N_GLOW_ADVANCES = 10
T0 = time.perf_counter()
_phase = "start"


class DeadlineExceeded(RuntimeError):
    pass


def _on_alarm(signum, frame):
    raise DeadlineExceeded(f"phase {_phase!r} overran the {BUDGET_S} s "
                           f"budget")


def phase(name: str) -> None:
    global _phase
    _phase = name
    log(f"phase {name}")


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def k1_case(name, idx, flat, ell_scatter, ell_scatter_ref, flush):
    """Hold K1 against its plain version on one shape; time K1, the plain
    version and one PyTorch call computing the same function, each cold
    (L2 flushed before every call) and warm (the same inputs every
    call)."""
    out = ell_scatter(flat, idx)
    ref = ell_scatter_ref(flat, idx)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if flat.dtype == torch.float64:
        tol = 1e-13 * scale  # exact up to summation order
    else:
        tol = 1e-6 * scale   # float32, rtol 1e-6
    check(err <= tol, f"K1 {name}: max |kernel - plain| = {err:.3e} > "
                      f"{tol:.3e}")
    # yardstick (never called by the port): scatter-add of the same rows
    n_flat = flat.shape[0]
    valid = (idx >= 0) & (idx < n_flat)
    dofs = torch.empty(n_flat, dtype=torch.long, device=idx.device)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(
        idx)
    dofs[idx[valid].long()] = rows[valid]
    C = flat[0].numel()

    def library(f, d):
        return torch.zeros((idx.shape[0], C), dtype=f.dtype,
                           device=f.device).index_add_(
            0, d, f.reshape(n_flat, C))

    lib_err = float((library(flat, dofs).reshape(ref.shape) - ref).abs()
                    .max())
    check(lib_err <= tol, f"index_add_ yardstick disagrees on {name}")
    n_dofs, max_val = idx.shape
    nbytes = (n_dofs * max_val * 4 + n_flat * C * flat.element_size()
              + n_dofs * C * flat.element_size())
    calls = [(flat, idx, dofs)] * 20
    timings = {}
    for key, fn in (("", lambda f, i, d: ell_scatter(f, i)),
                    ("plain_", lambda f, i, d: ell_scatter_ref(f, i)),
                    ("library_", lambda f, i, d: library(f, d))):
        timings[key + "ms"] = device_ms(fn, calls, flush)
        timings[key + "warm_ms"] = device_ms(fn, calls)
        timings[key + "eager_ms"] = eager_ms(lambda: fn(flat, idx, dofs))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    case = {"case": name, "n_dofs": n_dofs, "max_val": max_val,
            "n_flat": n_flat, "C": C, "dtype": str(flat.dtype),
            "max_abs_err": err, **timings, "bound_ms": bound_ms,
            "bytes": nbytes, "roofline_share": bound_ms / timings["ms"]}
    check(case["roofline_share"] <= 1.0, f"K1 {name} ran faster than its "
          f"memory bound: the timing is not cold")
    log(f"K1 {name}: err {err:.3e}; cold device us: kernel "
        f"{timings['ms'] * 1e3:.2f}, plain {timings['plain_ms'] * 1e3:.2f}, "
        f"index_add_ {timings['library_ms'] * 1e3:.2f}, bound "
        f"{bound_ms * 1e3:.2f} ({nbytes} B, share "
        f"{case['roofline_share']:.3f}); warm device "
        f"us: kernel {timings['warm_ms'] * 1e3:.2f}, plain "
        f"{timings['plain_warm_ms'] * 1e3:.2f}, index_add_ "
        f"{timings['library_warm_ms'] * 1e3:.2f}; eager us: kernel "
        f"{timings['eager_ms'] * 1e3:.2f}, plain "
        f"{timings['plain_eager_ms'] * 1e3:.2f}, index_add_ "
        f"{timings['library_eager_ms'] * 1e3:.2f}")
    return case


def k1_compact_case(name, rows, idx, dense_idx, dofs, flat, n_dofs, k1,
                    gen, flush):
    """Hold K1's compact form, out[rows] += sum_v flat[idx[:, v]], against
    its plain version and against the dense path it replaced, then time
    it, the plain version, in-place `index_add_` (one PyTorch call with the
    same function, never called by the port), the replaced path
    out + ell_scatter(flat, dense_idx), and the empty kernel on the same
    grid (the floor of a launch), each cold (L2 flushed before every call)
    and warm (the same inputs every call). With rows=None it is the dense
    form in place, out += sum_v flat[idx[:, v]] over every row (the
    glow's cell scatter), and the replaced path is the same sum added
    after a dense scatter."""
    C = flat.shape[1]
    out0 = torch.randn((n_dofs, C), generator=gen, device="cuda",
                       dtype=flat.dtype)
    got = k1.ell_scatter_add_(out0.clone(), flat, idx, rows)
    ref = k1.ell_scatter_add_ref(out0.clone(), flat, idx, rows)
    replaced = out0 + k1.ell_scatter(flat, dense_idx)
    lib = out0.clone().index_add_(0, dofs, flat)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = (1e-13 if flat.dtype == torch.float64 else 1e-6) * scale
    check(err <= tol, f"K1 {name}: max |kernel - plain| = {err:.3e} > "
                      f"{tol:.3e}")
    # same slots in the same order: bitwise the dense path's sums, and the
    # rows the table leaves out untouched
    check(torch.equal(got, replaced), f"K1 {name} differs from out + "
                                      f"the dense scatter")
    check(float((lib - ref).abs().max()) <= tol,
          f"index_add_ yardstick disagrees on {name}")
    n_rows, max_val = idx.shape
    size = flat.element_size()
    # rows (none on the dense form), idx, flat, out read + write
    nbytes = ((0 if rows is None else n_rows * 4) + n_rows * max_val * 4
              + flat.shape[0] * C * size + 2 * n_rows * C * size)
    fns = {"": lambda o: k1.ell_scatter_add_(o, flat, idx, rows),
           "plain_": lambda o: k1.ell_scatter_add_ref(o, flat, idx, rows),
           "library_": lambda o: o.index_add_(0, dofs, flat),
           "replaced_path_": lambda o: o + k1.ell_scatter(flat, dense_idx),
           "floor_": lambda o: k1.ell_noop(n_rows, C)}
    calls = [(out0,)] * 20
    timings = {}
    for key, fn in fns.items():
        timings[key + "ms"] = device_ms(fn, calls, flush)
        timings[key + "warm_ms"] = device_ms(fn, calls)
        timings[key + "eager_ms"] = eager_ms(lambda: fn(out0))
    # the kernel's cold time by CUDA events, the timing device_ms falls back
    # to where the profiler drops its traces, beside the profiler's
    timings["event_ms"] = event_ms(fns[""], calls, flush)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    case = {"case": name, "form": "compact" if rows is not None else
            "dense in place", "n_rows": n_rows,
            "n_dofs": n_dofs, "max_val": max_val, "n_flat": flat.shape[0],
            "C": C, "dtype": str(flat.dtype), "max_abs_err": err,
            **timings, "bound_ms": bound_ms, "bytes": nbytes,
            "roofline_share": bound_ms / timings["ms"],
            "vs_index_add": timings["ms"] / timings["library_ms"],
            "vs_replaced_path": timings["ms"] / timings["replaced_path_ms"]}
    check(case["roofline_share"] <= 1.0, f"K1 {name} ran faster than its "
          f"memory bound")
    us = {k: v * 1e3 for k, v in timings.items()}
    log(f"K1 {name}: err {err:.3e}; cold device us: kernel {us['ms']:.2f}, "
        f"floor {us['floor_ms']:.2f}, plain {us['plain_ms']:.2f}, "
        f"index_add_ {us['library_ms']:.2f}, out + dense "
        f"{us['replaced_path_ms']:.2f}, bound {bound_ms * 1e3:.4f} ({nbytes} B); "
        f"warm device us: kernel {us['warm_ms']:.2f}, floor "
        f"{us['floor_warm_ms']:.2f}, index_add_ {us['library_warm_ms']:.2f}, "
        f"out + dense {us['replaced_path_warm_ms']:.2f}; eager us: kernel "
        f"{us['eager_ms']:.2f}, index_add_ {us['library_eager_ms']:.2f}; "
        f"kernel cold by CUDA events {us['event_ms']:.2f}")
    return case


def _rel(got, ref) -> list:
    """|a - b| / |b|, and |a| where the reference is exactly 0."""
    return [abs(a - b) / abs(b) if b else abs(a) for a, b in zip(got, ref)]


def held_to(name, got, ref, rtols) -> list:
    """Relative gaps of `got` to `ref`, each checked against its rtol."""
    rel = _rel(got, ref)
    log(f"{name}: {got}, rel. to JAX {rel}")
    for k, (r, tol) in enumerate(zip(rel, rtols)):
        check(r <= tol, f"{name}[{k}] off the JAX reference by {r:.3e} > "
                        f"{tol:.1e}")
    return rel


def refused_by(name, got, ref, rtols) -> list:
    """Relative gaps of a lower-precision `got` to `ref`, each checked to
    exceed its rtol: the control that the tolerance can fail."""
    rel = _rel(got, ref)
    log(f"{name} (control): rel. to JAX {rel}")
    for k, (r, tol) in enumerate(zip(rel, rtols)):
        check(not r <= tol, f"{name}[{k}] is within {tol:.1e} of the JAX "
                            f"reference ({r:.3e}): the tolerance cannot "
                            f"tell it from the float64 defect")
    return rel


def counting(counts: dict, name: str, fn):
    """`fn`, adding to counts[name] its Krylov iterations (the third item
    it returns) or, for a Newton iteration, one per call."""
    def run(*args, **kw):
        out = fn(*args, **kw)
        counts[name] = counts.get(name, 0) + (
            1 if name == "newton_iteration" else int(out[2]))
        return out

    return run


def fresh_window(k1, card) -> dict:
    """Phase 4: the bagheri14 protocol from t = 0 on its moving window."""
    import tempfile

    import numpy as np

    from fedm_tpu_torch.bagheri_run import (build_driver, build_models,
                                            parse_args, window_corr)
    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.solvers import newton

    def norms(x):
        return [float(torch.linalg.vector_norm(x[:, k]))
                for k in range(x.shape[1])]

    def first_residual(model, s, dtype=torch.float64):
        p = StepParams(s.t + s.dt, s.dt, s.dt_old)
        return model.system.residual(s.u, s.u, s.u_old, p, dtype)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        args = parse_args(["--preset", "bagheri14", "--no-direct-rescue",
                           "--out", tmp])
        span, dz = args.window_span, args.window_dz
        corridor = window_corr(1e-2, span, dz)
        check(np.allclose(corridor, REF_WINDOW["corridor"], rtol=1e-15,
                          atol=0), "the window corridor differs")
        t = time.perf_counter()
        model, fallback = build_models(args, corridor)
        torch.cuda.synchronize()
        fb = model.system.facet_kernels[0][0]
        n_dofs = model.space.n_dofs
        out["build_s"] = time.perf_counter() - t
        out["n_dofs"] = n_dofs
        out["facet_compact_shape"] = list(fb.scatter_idx.shape)
        log(f"window model: {n_dofs} dofs ({3 * n_dofs} unknowns), "
            f"{model.mesh.n_cells} cells, facet compact table "
            f"{tuple(fb.scatter_idx.shape)}, built in {out['build_s']:.2f} s")
        check(n_dofs == REF_WINDOW["n_dofs"], f"{n_dofs} dofs, not "
                                              f"{REF_WINDOW['n_dofs']}")

        torch.cuda.synchronize()
        t = time.perf_counter()
        state = model.initial_state()
        torch.cuda.synchronize()
        out["poisson_s"] = time.perf_counter() - t
        out["poisson_relres"], out["poisson_iters"] = model.initial_poisson
        log(f"initial state in {out['poisson_s']:.3f} s: Poisson CG "
            f"{out['poisson_iters']} iterations, relres "
            f"{out['poisson_relres']:.3e}")
        out["initial_state_rel"] = held_to(
            "initial state norms", norms(state.u),
            REF_WINDOW["initial_state_norms"], WINDOW_STATE_RTOL)
        out["initial_residual_rel"] = held_to(
            "initial f64 residual norms", norms(first_residual(model, state)),
            REF_WINDOW["initial_residual_norms"],
            WINDOW_INITIAL_RESIDUAL_RTOL)
        out["initial_residual_f32_rel"] = refused_by(
            "initial f32 residual norms",
            norms(first_residual(model, state, torch.float32).double()),
            REF_WINDOW["initial_residual_norms"],
            WINDOW_INITIAL_RESIDUAL_RTOL)

        moved_to = window_corr(9.9e-3, span, dz)
        check(np.allclose(moved_to, REF_WINDOW["moved_to"], rtol=1e-15,
                          atol=0), "the moved corridor differs")
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = model.move_window(moved_to, state)
        torch.cuda.synchronize()
        out["move_window_s"] = time.perf_counter() - t
        log(f"move_window to {moved_to} in {out['move_window_s']:.3f} s")
        out["moved_state_rel"] = held_to(
            "moved state norms", norms(state.u),
            REF_WINDOW["moved_state_norms"], WINDOW_STATE_RTOL)
        F = first_residual(model, state)
        out["moved_residual_rel"] = held_to(
            "moved f64 residual norms", norms(F),
            REF_WINDOW["moved_residual_norms"], WINDOW_MOVED_RESIDUAL_RTOL)
        out["moved_residual_f32_rel"] = refused_by(
            "moved f32 residual norms",
            norms(first_residual(model, state, torch.float32).double()),
            REF_WINDOW["moved_residual_norms"], WINDOW_MOVED_RESIDUAL_RTOL)
        with mock.patch("fedm_tpu_torch.fem.assembly.ell_scatter_add_",
                        k1.ell_scatter_add_ref):
            F_plain = first_residual(model, state)
        check(torch.equal(F, F_plain), "K1 on the moved facets differs from "
                                       "its plain version")
        log("moved residual with K1 equals the plain version's exactly")

        driver = build_driver(args, model, fallback)
        acc0, rej0 = state.n_accepted, state.n_rejected
        # Newton iterations (a rescued one counts twice) and Krylov
        # iterations per advance, counted around the solver's calls
        counts = {}
        patches = {name: counting(counts, name, getattr(newton, name))
                   for name in ("newton_iteration", "bicgstab", "gmres")}
        k1.LAUNCHES.clear()
        step_s, per_advance = [], []
        with mock.patch.multiple(newton, **patches):
            for _ in range(N_WINDOW_ADVANCES):
                before = dict(counts)
                t = time.perf_counter()
                state = driver.advance(state, {})
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                per_advance.append({k: v - before.get(k, 0)
                                    for k, v in counts.items()})
                log(f"window advance {step_s[-1]:.2f} s, t = {state.t:.6e}"
                    f", dt = {state.dt:.3e}, accepted {state.n_accepted}, "
                    f"rejected {state.n_rejected}, iterations "
                    f"{per_advance[-1]}")
        launches = k1_launches(k1)
    accepted = state.n_accepted - acc0
    out.update({"advance_s": step_s, "iterations_per_advance": per_advance,
                "median_advance_s": statistics.median(step_s),
                "accepted": accepted,
                "rejected": state.n_rejected - rej0,
                "stall_accepted": driver.n_stall_accepted,
                "launches": launches,
                "k1_launches_per_advance":
                    launches["ell_scatter_add_"] / N_WINDOW_ADVANCES,
                "t": state.t, "card": card})
    check(all(bool(torch.isfinite(x).all())
              for x in (state.u, state.u_old, state.u_old1)),
          "non-finite window state")
    check(accepted >= 1, "no window advance was accepted")
    check(launches["ell_scatter_add_"] > 0,
          "the window path never launched K1's compact form")
    check(launches["ell_scatter"] == 0,
          "the window path launched K1's dense form")
    log(f"window: accepted {accepted}, rejected {out['rejected']}, median "
        f"{out['median_advance_s']:.3f} s/advance, K1 launches {launches} "
        f"({out['k1_launches_per_advance']:.1f} per advance); {card}")
    return out


def k1_launches(k1) -> dict:
    """K1's launches by wrapper since `k1.LAUNCHES` was last cleared."""
    return {w: k1.launch_count(w) for w in ("ell_scatter_add_",
                                            "ell_scatter")}


def glow_probe_state(u0: torch.Tensor, coords, cfg) -> torch.Tensor:
    """tools/port_reference_glow.py's probe state: the initial state with a
    cathode-fall potential and modulated log-densities."""
    import numpy as np

    r, z = coords[:, 0], coords[:, 1]
    u = u0.cpu().numpy().copy()
    mod = 0.5 * np.sin(np.pi * z / cfg.gap_length) * np.cos(
        0.5 * np.pi * r / cfg.wall)
    u[:, :4] += mod[:, None]
    u[:, 4] = cfg.U_w * (1.0 - z / cfg.gap_length) ** 2
    return torch.as_tensor(u, device=u0.device)


def glow(k1, card) -> dict:
    """Phase 5: the argon glow discharge at the glow50 protocol from
    t = 0."""
    import tempfile

    from fedm_tpu_torch.glow_run import build_driver, build_models, parse_args
    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.solvers import newton

    def norms(x):
        x = x.reshape(x.shape[0], -1)
        return [float(torch.linalg.vector_norm(x[:, k].double()))
                for k in range(x.shape[1])]

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        args = parse_args(["--preset", "glow50", "--out", tmp])
        t = time.perf_counter()
        model, fallback = build_models(args)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t
        cb = model.batch
        n_dofs = model.space.n_dofs
        out.update(n_dofs=n_dofs, unknowns=n_dofs * model.n_eq,
                   cell_table=list(cb.gather_idx.shape),
                   mg_lmax=model.mg.lmax,
                   mg_levels=[lev.n for lev in model.mg.levels])
        log(f"glow model: {n_dofs} dofs ({out['unknowns']} unknowns), "
            f"{model.mesh.n_cells} cells, dense cell table "
            f"{tuple(cb.gather_idx.shape)}, MG levels {out['mg_levels']} "
            f"with lmax {out['mg_lmax']}, built in {out['build_s']:.2f} s "
            f"(synthetic argon tree in a temporary directory)")
        check(n_dofs == REF_GLOW["n_dofs"] and model.n_eq == 5
              and model.mesh.n_cells == 16384,
              f"{n_dofs} dofs, {model.mesh.n_cells} cells")
        check(cb.scatter_rows is None and cb._structured is None
              and tuple(cb.gather_idx.shape) == (n_dofs, 8),
              "the glow's cell scatter is not K1's dense form")

        def residual(u, u_old1, params, dtype=torch.float64, aux=None):
            return model.system.residual(
                u, u, u_old1, StepParams(*params), dtype,
                aux=model._update_aux(u) if aux is None else aux)

        state = model.initial_state()
        first = (state.t + state.dt, state.dt, state.dt_old)
        out["initial_state_rel"] = held_to(
            "glow initial state norms", norms(state.u),
            REF_GLOW["initial_state_norms"], GLOW_STATE_RTOL)
        out["initial_residual_rel"] = held_to(
            "glow initial f64 residual norms",
            norms(residual(state.u, state.u_old1, first)),
            REF_GLOW["initial_residual_norms"], GLOW_INITIAL_RESIDUAL_RTOL)
        out["initial_residual_f32_rel"] = refused_by(
            "glow initial f32 residual norms",
            norms(residual(state.u, state.u_old1, first, torch.float32)),
            REF_GLOW["initial_residual_norms"], GLOW_INITIAL_RESIDUAL_RTOL)

        u = glow_probe_state(state.u, model.space.dof_coords, model.cfg)
        aux = model._update_aux(u)
        out["probe_aux_rel"] = {
            key: held_to(f"glow probe {key} norms", norms(aux[key]),
                         REF_GLOW["probe_aux_norms"][key],
                         [GLOW_AUX_RTOL[key]] * len(
                             REF_GLOW["probe_aux_norms"][key]))
            for key in GLOW_AUX_RTOL}
        F = residual(u, u, GLOW_PROBE_PARAMS, aux=aux)
        out["probe_residual_rel"] = held_to(
            "glow probe f64 residual norms", norms(F),
            REF_GLOW["probe_residual_norms"], GLOW_PROBE_RESIDUAL_RTOL)
        out["probe_residual_f32_rel"] = refused_by(
            "glow probe f32 residual norms",
            norms(residual(u, u, GLOW_PROBE_PARAMS, torch.float32)),
            REF_GLOW["probe_residual_norms"], GLOW_PROBE_RESIDUAL_RTOL)
        with mock.patch("fedm_tpu_torch.fem.assembly.ell_scatter",
                        k1.ell_scatter_ref), \
                mock.patch("fedm_tpu_torch.fem.assembly.ell_scatter_add_",
                           k1.ell_scatter_add_ref):
            F_plain = residual(u, u, GLOW_PROBE_PARAMS, aux=aux)
        k1_rel = [float(torch.linalg.vector_norm(F[:, k] - F_plain[:, k])
                        / max(float(torch.linalg.vector_norm(F_plain[:, k])),
                              1e-300)) for k in range(F.shape[1])]
        out["probe_residual_k1_vs_plain"] = k1_rel
        log(f"glow probe residual with K1 vs plain scatter (the same "
            f"coefficients): rel. diff {k1_rel}")
        # float64: the same sums, in another order inside a row; rows that
        # cancel to ~1e-4 of their terms show it at ~1e-13
        check(max(k1_rel) <= 1e-12, "K1 in the glow residual disagrees "
                                    "with the plain scatter")

        driver = build_driver(args, model, fallback)
        counts = {}
        patches = {name: counting(counts, name, getattr(newton, name))
                   for name in ("newton_iteration", "bicgstab", "gmres")}
        k1.LAUNCHES.clear()
        step_s, per_advance = [], []
        with mock.patch.multiple(newton, **patches):
            for _ in range(N_GLOW_ADVANCES):
                before = dict(counts)
                t = time.perf_counter()
                state.dt = min(state.dt, max(args.T - state.t,
                                             model.cfg.dt_min))
                state = driver.advance(state, model._update_aux(state.u))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                per_advance.append({k: v - before.get(k, 0)
                                    for k, v in counts.items()})
                log(f"glow advance {step_s[-1]:.2f} s, t = {state.t:.6e}, "
                    f"dt = {state.dt:.3e}, accepted {state.n_accepted}, "
                    f"rejected {state.n_rejected}, iterations "
                    f"{per_advance[-1]}")
        launches = k1_launches(k1)
        shapes = collections.Counter()
        for (_, table, C, dt), n in k1.LAUNCHES.items():
            shapes[f"{table} C={C} {dt}"] += n
        shapes = dict(sorted(shapes.items()))
    # "dense C=5 f32": the residual's and J v's cell scatter
    dense = sum(n for key, n in shapes.items() if key.startswith("dense"))
    attempts = state.n_accepted + state.n_rejected
    out.update({"advance_s": step_s, "iterations_per_advance": per_advance,
                "median_advance_s": statistics.median(step_s),
                "accepted": state.n_accepted, "attempts": attempts,
                "launches": launches, "launches_by_shape": shapes,
                "k1_launches_per_advance_by_shape":
                    {k: v / N_GLOW_ADVANCES for k, v in shapes.items()},
                "t": state.t, "card": card})
    check(all(bool(torch.isfinite(x).all())
              for x in (state.u, state.u_old, state.u_old1)),
          "non-finite glow state")
    check(state.n_accepted == N_GLOW_ADVANCES and state.t > 0,
          "the glow advances did not all land")
    check(dense > 0 and shapes.get("dense C=5 f32", 0) > 0,
          "the glow never launched K1's dense form on its cell scatter")
    log(f"glow: accepted/attempted {state.n_accepted}/{attempts}, median "
        f"{out['median_advance_s']:.3f} s/advance, K1 launches per advance "
        f"{out['k1_launches_per_advance_by_shape']}; {card}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(BUDGET_S)

    phase("0 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no answer"
    log(f"{kind} x{count}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    from fedm_tpu_torch.ops import cuda_build
    from fedm_tpu_torch.ops import ell_scatter as k1
    from fedm_tpu_torch.ops.ell_scatter import (SOURCE, ell_scatter,
                                                ell_scatter_add_ref,
                                                ell_scatter_ref)

    phase("1 build K1")
    t = time.perf_counter()
    path, nvcc_out = cuda_build.build(SOURCE)
    log(f"built {path.name} in {time.perf_counter() - t:.1f} s")
    for line in nvcc_out.splitlines():
        if "ptxas" in line:
            log(line.strip())

    phase("2 K1 vs plain")
    from fedm_tpu_torch.fem.assembly import build_ell_index
    from fedm_tpu_torch.io import load_checkpoint
    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.solvers.newton import NewtonConfig

    # the bench configuration (bench.py:88-111)
    nc = NewtonConfig(rtol=1e-3, max_iter=20, linear_tol=3e-2,
                      linear_maxiter=400, accept_reduction=3e-2,
                      hi_residual=True)
    cfg = StreamerConfig(dtype=torch.float32, newton=nc,
                         z_corridor=(0.0, 1.08e-2, 1e-5),
                         density_floor=1e13, r_corridor=(2e-3, 2e-5))
    model = StreamerModel(cfg, device="cuda")
    model.system.use_gather_scatter()
    fb = model.system.facet_kernels[0][0]
    n_dofs = model.space.n_dofs
    log(f"model built: {n_dofs} nodes, {model.mesh.n_cells} cells, "
        f"{fb.n_facets} electrode facets, facet ELL dense "
        f"{tuple(fb.gather_idx.shape)}, compact "
        f"{tuple(fb.scatter_idx.shape)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = l2_flush()
    cell_idx = torch.as_tensor(build_ell_index(model.batch.dofs_np, n_dofs),
                               device="cuda")
    shapes = [("facet", fb.gather_idx, fb.dofs.numel(), 3),
              ("facet-blocks", fb.gather_idx, fb.dofs.numel(), 9),
              ("cell", cell_idx, model.batch.dofs.numel(), 3)]
    cases = []
    for name, idx, n_flat, C in shapes:
        for dtype in (torch.float32, torch.float64):
            flat = torch.randn((n_flat, C), generator=gen, device="cuda",
                               dtype=dtype)
            cases.append(k1_case(f"{name} C={C} {str(dtype)[6:]}", idx,
                                 flat, ell_scatter, ell_scatter_ref, flush))
    # the compact form at the facet shape, as the main path calls it
    compact = []
    for C in (3, 9):
        for dtype in (torch.float32, torch.float64):
            flat = torch.randn((fb.dofs.numel(), C), generator=gen,
                               device="cuda", dtype=dtype)
            compact.append(k1_compact_case(
                f"facet compact C={C} {str(dtype)[6:]}", fb.scatter_rows,
                fb.scatter_idx, fb.gather_idx, fb.dofs.reshape(-1).long(),
                flat, n_dofs, k1, gen, flush))
    # K1 at the glow's shapes: the dense cell table of the crossed 64 x 64
    # mesh, as `project` (C=1, a new tensor), the residual and J v (C=5,
    # in place; float32 and the float64 defect) and the node blocks (C=25)
    # call it
    from fedm_tpu_torch.mesh import rectangle_mesh

    gmesh = rectangle_mesh((0, 0), (0.01, 0.01), 64, 64, "crossed")
    g_idx = torch.as_tensor(build_ell_index(gmesh.cells, gmesh.n_verts),
                            device="cuda")
    g_dofs = torch.as_tensor(gmesh.cells.reshape(-1), dtype=torch.long,
                             device="cuda")
    flat = torch.randn((gmesh.cells.size, 1), generator=gen, device="cuda")
    glow_cases = [k1_case("glow cell C=1 float32", g_idx, flat, ell_scatter,
                          ell_scatter_ref, flush)]
    for C, dtype in ((5, torch.float32), (5, torch.float64),
                     (25, torch.float32)):
        flat = torch.randn((gmesh.cells.size, C), generator=gen,
                           device="cuda", dtype=dtype)
        glow_cases.append(k1_compact_case(
            f"glow cell dense in place C={C} {str(dtype)[6:]}", None, g_idx,
            g_idx, g_dofs, flat, gmesh.n_verts, k1, gen, flush))
    del flush

    phase("3 main path")
    state = load_checkpoint(CKPT, device="cuda")
    check(state.u.shape[0] == n_dofs, "checkpoint/mesh mismatch")
    params = StepParams(state.t + state.dt, state.dt, state.dt_old)
    F = model.system.residual(state.u, state.u, state.u_old, params,
                              torch.float64)
    norms = [float(torch.linalg.vector_norm(F[:, k])) for k in range(3)]
    rel = [abs(a - b) / b for a, b in zip(norms, REF_RESIDUAL_NORMS)]
    log(f"f64 residual norms {norms}, rel. to JAX {rel}")
    check(max(rel) <= REF_RTOL, f"residual norms off the JAX reference by "
                                f"{max(rel):.3e} > {REF_RTOL}")
    with mock.patch("fedm_tpu_torch.fem.assembly.ell_scatter",
                    ell_scatter_ref), \
            mock.patch("fedm_tpu_torch.fem.assembly.ell_scatter_add_",
                       ell_scatter_add_ref):
        F_plain = model.system.residual(state.u, state.u, state.u_old,
                                        params, torch.float64)
    k1_rel = [float(torch.linalg.vector_norm(F[:, k] - F_plain[:, k])
                    / max(float(torch.linalg.vector_norm(F_plain[:, k])),
                          1e-300)) for k in range(3)]
    log(f"residual with K1 vs plain scatter: rel. diff {k1_rel}")
    check(max(k1_rel) <= 1e-12, "K1 residual disagrees with the plain one")

    driver = model.make_driver()
    t = time.perf_counter()
    state = driver.advance(state, {})
    torch.cuda.synchronize()
    log(f"warm-up advance {time.perf_counter() - t:.2f} s, t = "
        f"{state.t:.6e}, dt = {state.dt:.3e}")
    t_start, acc0, rej0 = state.t, state.n_accepted, state.n_rejected
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES.clear()
    step_s = []
    for _ in range(N_TIMED_ADVANCES):
        t = time.perf_counter()
        state = driver.advance(state, {})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        log(f"advance {step_s[-1]:.2f} s, t = {state.t:.6e}, dt = "
            f"{state.dt:.3e}, accepted {state.n_accepted}, rejected "
            f"{state.n_rejected}")
    launches = k1_launches(k1)
    peak = torch.cuda.max_memory_allocated()
    accepted = state.n_accepted - acc0
    attempts = accepted + state.n_rejected - rej0
    check(all(bool(torch.isfinite(x).all())
              for x in (state.u, state.u_old, state.u_old1)),
          "non-finite state")
    check(state.t > t_start and accepted == N_TIMED_ADVANCES,
          "time or accepted count did not grow")
    check(launches["ell_scatter_add_"] > 0,
          "the main path never launched K1's compact form")
    check(launches["ell_scatter"] == 0,
          "the main path launched K1's dense form")
    log(f"median {statistics.median(step_s):.3f} s/advance over "
        f"{N_TIMED_ADVANCES} (smoke number), accepted/attempted "
        f"{accepted}/{attempts}, K1 launches {launches}, peak memory "
        f"{peak / 2**30:.2f} GiB")

    unknowns = n_dofs * model.n_eq

    phase("4 fresh window")
    del model, driver, state
    window = fresh_window(k1, card)

    phase("5 glow")
    glow_out = glow(k1, card)
    signal.alarm(0)

    main_case = compact[0]  # facet C=3 float32: the main path's usual launch
    kernels = [{
        "name": "ell_scatter", "route": "cuda",
        "source": "fedm_tpu_torch/csrc/ell_scatter.cu",
        "replaces": "fedm_tpu/ops/pallas_scatter.py:34",
        "launches": (sum(launches.values())
                     + sum(window["launches"].values())
                     + sum(glow_out["launches"].values())),
        "launches_by_path": {"restart": launches,
                             "fresh_window": window["launches"],
                             "glow": glow_out["launches"]},
        "glow_launches_by_shape": glow_out["launches_by_shape"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in cases + compact + glow_cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
        "floor_ms": main_case["floor_ms"],
        "replaced_path_ms": main_case["replaced_path_ms"],
        # device times taken by CUDA events where the profiler dropped its
        # traces (each then ~4 us high, see devtime.event_ms); 0 in a
        # healthy run
        "event_timed": devtime.event_fallbacks,
        "cases": cases + compact + glow_cases}]
    print(json.dumps({
        "kernels": kernels,
        "main_path": {"unknowns": unknowns,
                      "advance_s": step_s,
                      "median_advance_s": statistics.median(step_s),
                      "accepted": accepted, "attempts": attempts,
                      "peak_bytes": peak, "residual_norms": norms,
                      "residual_rel_to_jax": rel},
        "fresh_window": window, "glow": glow_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except DeadlineExceeded as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        code = 1
    except Exception as exc:  # report the phase, then fail the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {_phase!r}: {exc}",
              file=sys.stderr, flush=True)
        code = 1
    sys.stdout.flush()
    os._exit(code)
