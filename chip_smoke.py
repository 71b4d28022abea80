"""Smoke test of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version, and drives the port's
paths at full size: the Bagheri streamer restart that `bench.py` times, the
streamer from t = 0 on its moving window with the direct rescue, the argon
glow, the streamer's option paths, the time-of-flight verification runs
(1D P2 and 2D axisymmetric) with their entry point, the extended
reaction scheme under the DOF-partitioned domain decomposition with its
entry point, the batched parameter sweep, the streamer example and the
domain decomposition at scale.

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
     after; the third runs BiCGStab to its cap and then the GMRES
     fallback, which must run;
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
     show launches of K1's dense form (the unstructured cell scatter);
  4b. rescue: the host sparse-direct Newton on phase 4's moved state (the
     window phase runs the preset as written, with this rescue as its
     fallback): the colour and node-pair counts of the JAX package, the
     probed Jacobian times three seeded vectors against the matrix-free
     J v (a distance-1 colouring must fail it), then one advance whose
     primary Newton cannot converge, escalated to `DirectNewton`, its
     residual norm per direct iteration and its increments held to the
     JAX package's numbers (tools/port_reference_options.py), each
     tolerance shown to refuse the same advance with the line search on
     the float32 residual; K1's launches counted around the advance;
  6. options: the JAX package's default StreamerConfig (graded 80 x 160,
     13,041 dofs, float64, poisson_precond "mg") built through
     `from_file_input` on a reference-format tree written to a temporary
     directory, its expressions and initial residual against the built-in
     model's, M r of "mg", "zline" and the transport z-lines on
     "mg-zline" and the row weights held to the JAX numbers (refusing a
     float32 model's M r), and one advance of each of "mg", "zline",
     transport_zline and float32 row_scaled, held to the JAX package's
     outcome, counts, dt and step error;
  7. tof: the 1D run at full width
     (TimeOfFlight1D, 4,000 P2 cells, 10 steps of 1e-11 s): its initial
     state and first float64 residual, its Newton iterations per step and
     its relative L2 error at 1e-10 held to the JAX package's numbers
     (tools/port_reference_tof.py); the 2D reference configuration
     (TimeOfFlight2D(): 40 x 40 P1 axisymmetric, 100 steps of 1e-12 s
     from 2.5e-9, or its first 20 where less than TOF_2D_FULL_RESERVE_S of
     the budget is left): Newton iterations per step and the errors at
     2.52e-9 and 2.6e-9 held to the JAX numbers, and the last within 1e-3
     of the reference's pinned 0.128997; each tolerance shown to refuse a
     control;
     K1's launches
     counted around each run (its dense forms are the ToF cell scatter);
     then `python -m fedm_tpu_torch.examples.tof_1d --quick` as a user
     runs it, its output tree and `relative error.log` checked;
  8. extended (run before 7, whose 2D run takes the length the budget
     left allows): the extended reaction scheme of `python -m
     fedm_tpu_torch.examples.extended_scheme` at its defaults (18 species,
     19 equations, crossed 32 x 64, 79,667 unknowns, float64), held to
     tools/port_reference_extended.py's JAX numbers: the native
     partitioner's 8 parts and the DD layout (n_own_max, n_ghost_max,
     shifts, a checksum of the parts); the model's size; the float64
     residual and node blocks, 8 parts on the card and undistributed, to
     each other and to the JAX norms, each tolerance shown to refuse the
     residual without the reverse halo exchange and in float32, phantom
     rows identity rows, `_dist_stiffness_op` against
     `masked_stiffness_op`; one step from the initial state, both ways,
     with the JAX package's Newton and BiCGStab counts, the states within
     1e-6 relative, K1's launches by shape counted around the distributed
     step; the entry point with `--devices 8 --steps 1` as a process;
     the streamer's DD at the default StreamerConfig (39,123 unknowns, 8
     parts): residual and node blocks against the undistributed system,
     one step with `enable_distributed_elliptic` against the
     undistributed step; 20 BiCGStab iterations of the distributed
     step's Krylov loop under the profiler (its idle share).
  9. sweep (run after 8): the batched sweep (`BatchedSweep`) of B = 8
     members of the JAX package's default StreamerConfig (graded 80 x 160,
     13,041 dofs and 39,123 unknowns each, 312,984 in the batch, float64,
     "mg"), seed amplitudes geomspace(1e18, 2e19, 8): the members'
     initial states, K1's launches per batched Krylov iteration at B = 1
     and B = 8 (equal), then 3 lockstep attempts and `run_until` 2e-11
     with K1's launch counter reset just before and read just after, held
     per member to tools/port_reference_sweep.py's JAX numbers (counts,
     t, dt, max_error, the states' column norms); each member's first
     attempt against the single-system step from the same state (the
     same Newton iterations), with the batch's wall time beside the 8
     single steps'; the control (one Newton-BiCGStab over the stacked
     members, scalars shared) must fail the tolerances;
  9b. the streamer example: `python -m fedm_tpu_torch.examples.streamer
     --quick -T 2e-11` as a process, its output tree, last line and
     `relative error.log` held to the JAX example's
     (tools/port_reference_streamer_example.py);
  10. dd_scale: `python -m fedm_tpu_torch.dd_scale` as a process at its
     defaults (280 x 560, 472,923 unknowns, 8 parts stacked on the card,
     2 steps, then the same steps undistributed): the size and the
     partition (20,196 own + 562 ghost rows a part), the Newton
     iterations and the step errors held to
     bench_assets/dd_scale_r03.log, the step times recorded both ways.
The glow phase (5) also checks that two V-cycles of one vector, and two
advances from one state, give the same bits (the unstructured levels
and the restriction sum through K1's dense form, F3); the options phase
(6) that the file-input model's initial state equals the built-in one's
bit for bit, and it holds the float32 row-scaled advance's Newton and
BiCGStab counts to the JAX package's spread and to a second advance from
the same state, bit for bit. `examples.glow_discharge` is not run here:
its XDMF/HDF5 output needs h5py, which the card's machine does not have
(its CPU test holds it to the JAX example).
Phase 2 also holds and times K1 at the time-of-flight tables (float64,
C = 1: the 1D P2 mesh's 8,001 rows x 2 slots, the 2D P1 mesh's 1,681 x 6),
both dense forms, with the empty-kernel floor on their grids, and at the
glow's shapes: the dense cell table
of the crossed 64 x 64 mesh (8,321 rows x 8 slots) at C = 1 (`project`),
5 (residual and Jacobian action, float32 and the float64 defect) and 25
(node blocks), and at the extended scheme's tables, float64: the stacked
DD tables (8 parts) in their compact form over their live rows, the cell
table at C = 19 and 361, the facet table at C = 19, and `ell_scatter` at
C = 1 on the undistributed cell table; and at this slice's: the glow
V-cycle's second level table and its restriction table (C = 1, float32),
the sweep's stacked tables (B = 8: the cell table in place at C = 3 and
9, the facet table's compact form at C = 3 and 9, float64) and dd_scale's
(280 x 560 on 8 parts: both tables' compact form, at the same C).
The script stops with a non-zero exit if any check fails or the whole run
passes its time budget. Its last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import collections
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
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
# the third advance from the moved state is the slow one (BiCGStab to its
# cap, then GMRES: 44-89 s on the H100), the problem's sensitivity
# (PERF.md, sec. 6), and the only place where the card runs the GMRES
# fallback
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
# The rescue's and the options' reference numbers, computed with the JAX
# package on the CPU by:  JAX_PLATFORMS=cpu python
# tools/port_reference_options.py (see its docstring for what each is)
REF_RESCUE = {
    "n_colors": 9, "n_pairs": 210721, "escalated": 1, "rejected": 0,
    "factorizations": 2,
    "direct_history": [[209809853556865.5, 245675098766.22217,
                        2158155103.3290367]],
    "increment_norms": (0.009456056140778737, 3.865517380894817,
                        262.27145826290126)}
REF_OPTION_ADVANCES = {
    "mg": {"accepted": 1, "rejected": 0, "dt": 5e-12,
           "error": 0.00027784198096289704,
           "iterations": {"newton_iteration": 3, "bicgstab": 18},
           "spread": {"newton_iteration": (3, 3), "bicgstab": (18, 18)}},
    "zline": {"accepted": 1, "rejected": 0, "dt": 5e-12,
              "error": 0.00027784198099656683,
              "iterations": {"newton_iteration": 3, "bicgstab": 133},
              "spread": {"newton_iteration": (3, 3),
                         "bicgstab": (133, 136)}},
    "tzline": {"accepted": 1, "rejected": 0, "dt": 5e-12,
               "error": 0.00027784198099567486,
               "iterations": {"newton_iteration": 3, "bicgstab": 49},
               "spread": {"newton_iteration": (3, 3),
                          "bicgstab": (39, 49)}},
    "row_scaled_f32": {"accepted": 1, "rejected": 0, "dt": 5e-12,
                       "error": 0.00027790645877635167,
                       "iterations": {"newton_iteration": 11,
                                      "bicgstab": 70},
                       "spread": {"newton_iteration": (9, 15),
                                  "bicgstab": (53, 85)}}}
REF_OPTIONS = {
    "n_dofs": 13041,
    "precond": {
        "mg": {"norms": [0.014960585488022185, 33.19700431952437,
                         86281.43131002354],
               "dots": [0.008116856275229838, 8.040835773303204,
                        19562.882212355573]},
        "zline": {"norms": [0.014960585290054475, 33.19700431546041,
                            43808.16812107061],
                  "dots": [0.008116856143124579, 8.040835768413801,
                           38383.4971034365]},
        "tzline": {"norms": [0.014960585455826661, 7.210195171860641e-11,
                             81750.56457387474],
                   "dots": [0.008116856253118622, 5.093853803264921e-12,
                            15786.68539670464]}},
    "row_weights": {"norms": [1.7788026911929446e-11, 2.56001126246306e-11,
                              15604.834931334768],
                    "dots": [1.2716424203630859e-11,
                             -1.5626822962365693e-11, 21450.001737179697]},
    "advance": REF_OPTION_ADVANCES}
# Relative tolerances of the rescue, each a few times the port's gap on the
# CPU (tools/port_reference_options.py --port), each refusing the control
# (the direct steps with the line search on the float32 residual instead
# of the float64 defect). Per position: the gap, the limit, the control.
#   direct ||F||, start and after iterations 1, 2:
#     CPU 2.4e-9 9.0e-8 4.5e-7; H100 2.5e-9 4.0e-7 1.7e-7; limit 1e-8 2e-6
#     3e-6; control 1.3e-6 6.6e-2 46.6
#   per-equation ||u_new - u_old||:
#     CPU 4.6e-10 2.0e-9 1.9e-6; H100 6.5e-11 1.8e-9 1.2e-6; limit 5e-9
#     2e-8 1e-5; control 9.9e-7 1.1e-6 6.0e-4
# and the probed Jacobian's J v against the matrix-free one (float32
# rounding, CPU 6.9e-8 to 7.2e-8; a distance-1 colouring 0.37).
RESCUE_HISTORY_RTOL = (1e-8, 2e-6, 3e-6)
RESCUE_INCREMENT_RTOL = (5e-9, 2e-8, 1e-5)
RESCUE_JV_RTOL = 1e-5
# The options' tolerances: M r and the row weights (per-column norms and
# dots) to 1e-10 relative (CPU at most 5.6e-12), refusing M r of the
# float32 model (CPU 5e-9 and above); dt and the accepted step's error to
# 1e-11 in float64 (CPU at most 4.3e-13, H100 1.0e-13) and 1e-3 for the
# float32 row-scaled advance (CPU and H100 2.3e-4). In float64 the Newton
# and BiCGStab counts must lie in the range the JAX package's own counts
# take over six seeded 1e-12 perturbations of the state (`spread`): "mg"
# 18 only, "zline" 133-136, "tzline" 39-49 (the port: CPU 41, H100 41).
# In float32 they must lie in the JAX package's own range over 24 seeded
# 1e-7 perturbations (tools/port_reference_options.py --only
# row_scaled_f32 --spread-seeds 24): Newton 9-15, BiCGStab 53-85 (6 seeds
# gave 10-13 and 61-74, which missed the H100's 13 and 84), and a second
# advance from the same state must repeat them and its state bit for bit
# (the segment sums are deterministic since F3; before, the counts moved
# from run to run).
OPTIONS_PRECOND_RTOL = 1e-10
OPTIONS_STEP_RTOL = (1e-11, 1e-3)
# the options phase's configurations (StreamerConfig overrides of the JAX
# default, built through from_file_input)
OPTION_CONFIGS = {"mg": {}, "zline": {"poisson_precond": "zline"},
                  "tzline": {"poisson_precond": "mg-zline",
                             "transport_zline": True},
                  "row_scaled_f32": {"row_scaled": True,
                                     "dtype": torch.float32}}
# the rescue's primary Newton, too weak to converge
RESCUE_WEAK = dict(max_iter=1, linear_maxiter=1, rtol=1e-10,
                   accept_reduction=0.0, max_stalls=1)
# The time-of-flight runs' reference numbers, computed with the JAX package
# on the CPU in float64 by:  JAX_PLATFORMS=cpu python
# tools/port_reference_tof.py  (1d: TimeOfFlight1D(TofConfig(dt=1e-11,
# T_final=1e-10), n_cells=4000); 2d: TimeOfFlight2D(), the reference
# configuration, with its error also at 2.52e-9 after 20 steps; quick:
# `examples/tof_1d.py --quick`'s three errors). Norms are 2-norms of the
# state u = ln n_e and of the float64 residual of the first step at
# delta = 0 (t = dt, dt_old = 1e30).
REF_TOF = {
    "1d": {"n_dofs": 8001, "initial_state_norm": 1403.3041635429788,
           "initial_residual_norm": 11501.028852680634,
           "newton_iterations": [7, 4, 4, 4, 4, 4, 4, 4, 4, 4],
           "errors": [[1.0000000000000002e-10, 0.0024141631466586162]]},
    "2d": {"n_dofs": 1681, "newton_iterations": [3] * 100,
           "errors": [[2.519999999999998e-09, 0.026534805970483872],
                      [2.5999999999999894e-09, 0.12904273381322798]]},
    "quick": {"errors": [[1.0000000000000002e-10, 0.002414163146655098],
                         [1.9999999999999996e-10, 0.0021210207742292054],
                         [3.0000000000000005e-10, 0.0018570668340233947]]}}
# the reference CI's pinned 2D error (tests/verification/test_tof.py:14),
# held within rel 1e-3 as that test holds the JAX package
TOF_PINNED_L2 = 0.128997491202745
TOF_PINNED_RTOL = 1e-3
# The 2D reference configuration runs 100 steps (2.5e-9 -> 2.6e-9). On one
# H100 at 700 W they take 13-17 s with the float64 element Jacobians
# (60-76 s with a forward-mode pass per product), `tof_1d --quick` 21-31 s
# after them, and the phases before the 2D run 440-480 s (the window's
# advances vary the most: one slow advance has taken 44-89 s). The phase runs all 100 when at
# least TOF_2D_FULL_RESERVE_S of the budget remain after the 1D run, else
# its first 20 (to 2.52e-9), and records which ("2d_steps"); the whole
# 100-step run also goes through the entry point
# (`python -m fedm_tpu_torch.examples.tof_2d`; PERF.md, section 6).
TOF_2D_STEPS_FULL, TOF_2D_STEPS_CUT = 100, 20
TOF_2D_FULL_RESERVE_S = 90
# Relative tolerances of the ToF phase, each set from the port's gaps to
# the JAX numbers (CPU: tools/port_reference_tof.py --port; H100: this
# phase, NVIDIA H100 80GB HBM3, 700 W) with a margin, and each shown to
# refuse a control (checked by the phase). Per quantity: the CPU gap, the
# H100 gap, the limit, the control's gap:
#   1D initial state norm   1.1e-14  0        1e-13  1.3e-8 (float32 state)
#   1D first residual norm  7.9e-15  1.1e-14  1e-12  7.4e-6 (in float32)
#   relative L2 errors      2.2e-13  1.0e-13  2e-12  8.8e-4 (2D; 1D 16.5:
#                                                    the exact solution one
#                                                    step early)
TOF_STATE_RTOL = 1e-13
TOF_RESIDUAL_RTOL = 1e-12
TOF_ERROR_RTOL = 2e-12
# The extended scheme's reference numbers (phase 8), computed with the JAX
# package on the CPU with 8 virtual devices by:  JAX_PLATFORMS=cpu python
# tools/port_reference_extended.py  (examples/extended_scheme.py's
# defaults: 18 species, crossed 32 x 64, float64, mg_levels 0, quadrature
# 2; the partition of the dual graph into 8 parts and the JAX
# DistributedSystem's layout; the first attempted step's float64 residual
# and node-block row norms at the initial state; the single-device step's
# Newton and BiCGStab counts and state; the example's lines with
# --devices 8 --steps 1)
EXT_PARTS, EXT_SPECIES = 8, 18
REF_EXTENDED = {
    "partition": {
        "part_checksum": 128464896,
        "part_sizes": [1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024],
        "n_own_max": 553,
        "n_ghost_max": 33,
        "shifts": [1]},
    "model": {
        "n_species": 18,
        "n_eq": 19,
        "n_dofs": 4193,
        "unknowns": 79667,
        "n_reactions": 60,
        "species": ["Ar[1p0]", "Ar[L01]", "Ar[L02]", "Ar[L03]", "Ar[L04]",
            "Ar[L05]", "Ar[L06]", "Ar[L07]", "Ar[L08]", "Ar[L09]", "Ar[L10]",
            "Ar[L11]", "Ar[L12]", "Ar[L13]", "Ar2[*]", "Ar[+]", "Ar2[+]",
            "e"]},
    "initial": {
        "params": [1e-13, 1e-13, 1e+30],
        "state_norms": [1860.340819988003, 1789.201962865558,
            1789.201962865558, 1789.201962865558, 1789.201962865558,
            1789.201962865558, 1789.201962865558, 1789.201962865558,
            1789.201962865558, 1789.201962865558, 1789.201962865558,
            1789.201962865558, 1789.201962865558, 1789.201962865558,
            1789.201962865558, 1789.201962865558, 1789.201962865558,
            1789.201962865558, 10.653797434089558],
        "residual_norms": [119385819739492.97, 938801807176.4933,
            621358512465.0486, 439981402196.76764, 324553862095.74457,
            245894754848.22748, 189707935979.41132, 148178058585.02847,
            116681390744.17078, 92315111107.04196, 73171533048.579,
            57951532505.48925, 45746689429.64587, 35911136682.814186,
            20256604960.729492, 254314217090.38654, 12625988975.642107,
            25723513169392.64, 0.14360688569949528],
        "block_row_norms": [9.314499096063396e+17, 2.950179721637785e+17,
            2.950179646895026e+17, 2.9501795846671776e+17,
            2.9501795320228166e+17, 2.950179486903713e+17,
            2.9501794478026406e+17, 2.9501794135904154e+17,
            2.9501793834035603e+17, 2.950179356571298e+17,
            2.950179332563813e+17, 2.9501793109572326e+17,
            2.950179291408476e+17, 2.950179273636918e+17,
            2.950179309469459e+17, 2.950179308652523e+17, 2.9501793802949e+17,
            2.9616102377643354e+17, 14.075854045463007]},
    "step": {
        "newton_iterations": 2,
        "bicgstab_iterations": 232,
        "gmres_iterations": 0,
        "state_norms": [1860.3382598746887, 1789.2020657365094,
            1789.202030899981, 1789.2020109937207, 1789.2019983235373,
            1789.2019896871427, 1789.2019835155786, 1789.2019789509723,
            1789.201975485571, 1789.2019728003445, 1789.2019706852495,
            1789.2019689967292, 1789.2019676336217, 1789.201966522789,
            1789.201960671968, 1789.2019904430365, 1789.2019625510652,
            1789.2014150615678, 9.934789987506576]},
    # BiCGStab's count moves with rounding: the JAX package's own counts
    # over the unperturbed step and 20 from the state scaled by
    # (1 + 1e-12 * seeded noise) span 213-264 (Newton 2 in every one)
    "spread": {"bicgstab_iterations": [213, 264]},
    "example": {
        "lines": ["18 species, 19 equations/node, 4193 dofs = 79667 "
                  "unknowns, 60 reactions",
                  "distributed over 8 devices: 553 own + 33 ghost rows/dev"],
        "accepted": 2, "rejected": 0, "t": 6.808e-13,
        "ne_max": 1.003e12, "eps_mean": 3.0}}
# Tolerances of phase 8. Against the JAX norms, per row: the state 1e-13
# (the same closed form; CPU gap 9.2e-15 on the potential, 0 elsewhere),
# the float64 residual 1e-12 and the node blocks' rows 1e-12 (CPU gaps at
# most 5.9e-15 and 2.2e-16, tools/port_reference_extended.py --port); the
# residual in float32 misses by 2.0e-8 to 3.3e-6 and without the reverse
# halo exchange by 1.4e-3 to 3.4e-2, and the phase checks that both fail.
# Distributed against undistributed (residual, node blocks,
# `_dist_stiffness_op`): rtol 1e-10, atol 1e-12 of the largest entry (the
# JAX DD test's; CPU 2.1e-17 of the largest). The step's states: rtol
# 1e-6, atol 1e-10 (the JAX DD test's: Newton stops at rtol 1e-4).
EXT_STATE_RTOL = 1e-12
EXT_RESIDUAL_RTOL = [1e-12] * 19
EXT_BLOCKS_RTOL = 1e-12
EXT_OPS_RTOL, EXT_OPS_ATOL_REL = 1e-10, 1e-12
EXT_STEP_RTOL, EXT_STEP_ATOL = 1e-6, 1e-10
EXT_PROFILED_ITERS = 20
# The batched sweep's reference numbers (phase 9), computed with the JAX
# package on the CPU by:  JAX_PLATFORMS=cpu python
# tools/port_reference_sweep.py  (BatchedSweep over B = 8 members of the
# default StreamerConfig, graded 80 x 160, float64, "mg", seed amplitudes
# geomspace(1e18, 2e19, 8); per member the initial states' column norms,
# the first attempt's Newton iterations, and after each of 3 attempts and
# after run_until(2e-11): the counts, t, dt, max_error and the state's
# column norms)
SWEEP_B = 8
SWEEP_AMPS = tuple(float(a) for a in np.geomspace(1e18, 2e19, SWEEP_B))
SWEEP_ATTEMPTS = 3
SWEEP_HORIZON = 2e-11
SWEEP_PROFILED_ITERS = 20
REF_SWEEP = {
    "initial": [[3470.6365421583196, 3418.3339510248147,
        1457347.647546141], [3474.597419825185, 3418.3339510248147,
        1462778.6890561387], [3478.7126715510462, 3418.3339510248147,
        1471214.177333928], [3482.982836578452, 3418.3339510248147,
        1484394.6485969678], [3487.4084310308826, 3418.3339510248147,
        1505162.725875443], [3491.989947606089, 3418.3339510248147,
        1538256.4867449312], [3496.727854222533, 3418.3339510248147,
        1591734.0881322925], [3501.622594770474, 3418.3339510248147,
        1679492.8472147426]],
    "first_newton": [2, 2, 2, 2, 3, 4, 5, 2],
    "attempts": [
        {"n_accepted": [1, 1, 1, 1, 1, 0, 0, 0], "n_rejected": [0, 0, 0, 0,
            0, 1, 1, 1], "t": [5e-12, 5e-12, 5e-12, 5e-12, 5e-12, 0.0, 0.0,
            0.0], "dt": [5e-12, 5e-12, 5e-12, 5e-12, 5e-12,
            2.3585968904357434e-12, 8.79836158028602e-13, 2.5e-12],
            "max_error": [[1.128420924710868e-05, 1.0, 1.0],
            [1.8698382577412658e-05, 1.0, 1.0], [4.1214097101459843e-05, 1.0,
            1.0], [0.00011924570693360585, 1.0, 1.0], [0.00036190281663142095,
            1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
            "u_norms": [[3470.62071836914, 3418.3211229818135,
            1457347.6470622402], [3474.581680576234, 3418.324690662721,
            1462778.6883072914], [3478.6970447070794, 3418.334725896549,
            1471214.1761804945], [3482.96740837496, 3418.3699479073084,
            1484394.646900831], [3487.3935388679633, 3418.4953069502662,
            1505162.724336324], [3491.989947606089, 3418.3339510248147,
            1538256.4867449312], [3496.727854222533, 3418.3339510248147,
            1591734.0881322925], [3501.622594770474, 3418.3339510248147,
            1679492.8472147426]]},
        {"n_accepted": [2, 2, 2, 2, 2, 1, 1, 0], "n_rejected": [0, 0, 0, 0,
            0, 1, 1, 2], "t": [1e-11, 1e-11, 1e-11, 1e-11, 1e-11,
            2.3585968904357434e-12, 8.79836158028602e-13, 0.0], "dt": [5e-12,
            5e-12, 5e-12, 5e-12, 5e-12, 5e-12, 1.894247447649398e-12,
            3.7561741769392476e-13], "max_error": [[1.1279008641139489e-05,
            1.128420924710868e-05, 1.0], [1.8684676358422563e-05,
            1.8698382577412658e-05, 1.0], [4.1184020603769915e-05,
            4.1214097101459843e-05, 1.0], [0.00011915863800082703,
            0.00011924570693360585, 1.0], [0.00036154607757241255,
            0.00036190281663142095, 1.0], [0.0005005011274032053, 1.0, 1.0],
            [0.0005010323302952167, 1.0, 1.0], [1.0, 1.0, 1.0]], "u_norms":
            [[3470.6048945917896, 3418.308291868667, 1457347.646577729],
            [3474.565941337195, 3418.3154228295452, 1462778.6875570829],
            [3478.6814178717427, 3418.335484578445, 1471214.1750195648],
            [3482.951980197284, 3418.405923009409, 1484394.6451268154],
            [3487.378646970417, 3418.656819664002, 1505162.721968605],
            [3491.9838532686344, 3418.596297707631, 1538256.4874371167],
            [3496.727028424328, 3418.6229871642245, 1591734.0899492034],
            [3501.622594770474, 3418.3339510248147, 1679492.8472147426]]},
        {"n_accepted": [3, 3, 3, 3, 3, 1, 1, 1], "n_rejected": [0, 0, 0, 0,
            0, 2, 2, 2], "t": [1.5e-11, 1.5e-11, 1.5e-11, 1.5e-11, 1.5e-11,
            2.3585968904357434e-12, 8.79836158028602e-13,
            3.7561741769392476e-13], "dt": [5e-12, 5e-12, 5e-12, 5e-12, 5e-12,
            2.3590461242830997e-12, 8.785886218166888e-13,
            8.088308259693599e-13], "max_error": [[1.5031747653368251e-05,
            1.1279008641139489e-05, 1.128420924710868e-05],
            [2.489464221946286e-05, 1.8684676358422563e-05,
            1.8698382577412658e-05], [5.487212158158691e-05,
            4.1184020603769915e-05, 4.1214097101459843e-05],
            [0.00015877853840812282, 0.00011915863800082703,
            0.00011924570693360585], [0.0004815871755214016,
            0.00036154607757241255, 0.00036190281663142095],
            [0.0005005011274032053, 1.0, 1.0], [0.0005010323302952167, 1.0,
            1.0], [0.0005006904853867972, 1.0, 1.0]], "u_norms":
            [[3470.5837962392766, 3418.2911797127513, 1457347.6459311622],
            [3474.544955699958, 3418.303056023337, 1462778.6865547558],
            [3478.660582104584, 3418.3364759040924, 1471214.1734573292],
            [3482.9314093307744, 3418.4538757248215, 1484394.6426010332],
            [3487.358791480457, 3418.8724749865837, 1505162.716950368],
            [3491.9838532686344, 3418.596297707631, 1538256.4874371167],
            [3496.727028424328, 3418.6229871642245, 1591734.0899492034],
            [3501.624979565057, 3418.6487052615566, 1679492.849753184]]},
    ],
    "run_until": {"n_accepted": [4, 4, 4, 4, 4, 8, 25, 55], "n_rejected":
        [0, 0, 0, 0, 0, 2, 3, 4], "t": [2e-11, 2e-11, 2e-11, 2e-11, 2e-11,
        2e-11, 2e-11, 2e-11], "dt": [5e-12, 5e-12, 5e-12, 5e-12, 5e-12,
        2.3438466535728455e-12, 8.051997871666522e-13, 3.4926539117132624e-13],
        "max_error": [[1.6273417998001068e-05, 1.5031747653368251e-05,
        1.1279008641139489e-05], [2.694028640648692e-05, 2.489464221946286e-05,
        1.8684676358422563e-05], [5.938147781757082e-05, 5.487212158158691e-05,
        4.1184020603769915e-05], [0.000171837785620674, 0.00015877853840812282,
        0.00011915863800082703], [0.0005209722970614367, 0.0004815871755214016,
        0.00036154607757241255], [0.0008156640208461093, 0.0009938556039368067,
        0.0009384956926494792], [0.0008402707685804429, 0.0009607194156789653,
        0.0009541873501401064], [0.0007419768583332746, 0.0009579475232840766,
        0.0009660670623658129]], "u_norms": [[3470.5609397147896,
        3418.2726350285398, 1457347.6452302402], [3474.52222127965,
        3418.289642767993, 1462778.685467072], [3478.638010040899,
        3418.337515058068, 1471214.1717516365], [3482.909124280958,
        3418.5057758885005, 1484394.6397102675], [3487.3372819719384,
        3419.106380189657, 1505162.7095425331], [3491.915267669831,
        3421.590508742324, 1538256.2959095], [3496.6955088159143,
        3430.7488933008854, 1591720.5673689772], [3502.244978036839,
        3453.715268604512, 1662547.3885003712]], "attempts": 56}}
# Tolerances of phase 9, relative, the largest gap over the members. The
# step error is a ratio of small differences: the JAX package's own sweep
# from its initial states scaled by (1 + 1e-15 * seeded noise), two seeds
# (tools/port_reference_sweep.py --spread 2), lands after the 3 attempts
# within t 1.5e-14, dt 2.7e-14, max_error 4.4e-13, column norms 8.3e-16
# of its unperturbed run, and after run_until's 56 attempts within dt
# 2.5e-9, max_error 1.2e-8, column norms 8.1e-12. The port on the H100
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 9.4e-16, 1.5e-15, 1.5e-14,
# 2.0e-14 after the attempts; 1.1e-9, 2.0e-9, 3.0e-12 after run_until. Each limit sits
# above the JAX package's own spread; the counts and run_until's t (the
# horizon) are exact. The control (the same batch through one
# Newton-BiCGStab with scalars shared across the members) changes the
# members' accept/reject verdicts within the 3 attempts and fails every
# limit of the attempts. The initial states' column norms 1e-11 (the
# Poisson CG's rounding; H100 2.0e-14); a member's first attempt against
# its single step 1e-11 of each column's max (H100 1.2e-16), with the
# same Newton iterations.
SWEEP_ATTEMPT_RTOL = {"t": 1e-12, "dt": 1e-12, "max_error": 5e-12,
                      "u_norms": 1e-12}
SWEEP_UNTIL_RTOL = {"t": 1e-12, "dt": 1e-7, "max_error": 1e-7,
                    "u_norms": 1e-10}
SWEEP_INITIAL_RTOL = 1e-11
SWEEP_SINGLE_RTOL = 1e-11
# bench_assets/dd_scale_r03.log, the JAX tool's run on 8 virtual CPU
# devices: (dofs, unknowns, own rows, ghost rows) per part, the Newton
# iterations of every step and the first two steps' errors (the tool's
# default --steps 2), logged to 4 digits; the tolerance is half a unit of
# the log's last digit (1.8e-4 relative; the port's distributed and
# undistributed errors agree to 8e-15 on the H100, and its CPU run at
# 16 x 24 to the JAX package's to 1.5e-14: tests/test_torch_dd_scale.py)
DD_SCALE_REF = {"layout": (157641, 472923, 20196, 562), "newton": 3,
                "errors": (2.791e-04, 2.789e-04)}
DD_SCALE_ERR_ATOL = 0.5e-7
# `examples/streamer.py --quick -T 2e-11` with the JAX package on the CPU:
# tools/port_reference_streamer_example.py
REF_STREAMER_EXAMPLE = {
    "tree": ["mesh", "mesh/mesh info.txt", "mesh/mesh.vtu", "model.log",
             "number density", "number density/Ions",
             "number density/Ions/Ions.pvd",
             "number density/Ions/Ions000000.vtu",
             "number density/Ions/Ions000001.vtu",
             "number density/electrons",
             "number density/electrons/electrons.pvd",
             "number density/electrons/electrons000000.vtu",
             "number density/electrons/electrons000001.vtu", "potential",
             "potential/Phi", "potential/Phi/Phi.pvd",
             "potential/Phi/Phi000000.vtu", "potential/Phi/Phi000001.vtu",
             "relative error.log"],
    "errors": [[0.0002534259436661263, 1e+30, 5e-12],
               [0.0002531871429207299, 5e-12, 5e-12],
               [0.00025287251946990287, 5e-12, 5e-12],
               [0.0002525336867982038, 5e-12, 5e-12]],
    "last_line": "Finished: 4 steps (0 rejected)"}
# the step errors to 1e-11 relative (CPU gap 3.6e-15; the options phase's
# float64 step errors sit 1.0e-13 from JAX's on the H100)
STREAMER_EXAMPLE_RTOL = 1e-11
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
    call), and the empty kernel on the call's grid cold (the floor)."""
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
    # the empty kernel on the call's grid: the floor of a launch
    from fedm_tpu_torch.ops.ell_scatter import ell_noop

    timings["floor_ms"] = device_ms(
        lambda f, i, d: ell_noop(n_dofs, max_val, C), calls, flush)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    case = {"case": name, "n_dofs": n_dofs, "max_val": max_val,
            "n_flat": n_flat, "C": C, "dtype": str(flat.dtype),
            "max_abs_err": err, **timings, "bound_ms": bound_ms,
            "bytes": nbytes, "roofline_share": bound_ms / timings["ms"]}
    check(case["roofline_share"] <= 1.0, f"K1 {name} ran faster than its "
          f"memory bound: the timing is not cold")
    log(f"K1 {name}: err {err:.3e}; cold device us: kernel "
        f"{timings['ms'] * 1e3:.2f}, floor {timings['floor_ms'] * 1e3:.2f}, "
        f"plain {timings['plain_ms'] * 1e3:.2f}, "
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
           "floor_": lambda o: k1.ell_noop(n_rows, max_val, C)}
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
        # the preset as written: its direct rescue is the fallback
        args = parse_args(["--preset", "bagheri14", "--out", tmp])
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
        moved = state

        driver = build_driver(args, model, fallback)
        check(type(driver.fallback_system).__name__ == "DirectNewton",
              "the bagheri14 window runs without its direct rescue")
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
                "escalated_to_direct": driver.n_escalated,
                "direct_factorizations":
                    driver.fallback_system.n_factorizations,
                "launches": launches,
                "k1_launches_per_advance":
                    launches["ell_scatter_add_"] / N_WINDOW_ADVANCES,
                "t": state.t, "card": card})
    check(all(bool(torch.isfinite(x).all())
              for x in (state.u, state.u_old, state.u_old1)),
          "non-finite window state")
    check(accepted >= 1, "no window advance was accepted")
    check(sum(a.get("gmres", 0) for a in per_advance) > 0,
          "the window advances never reached the GMRES fallback")
    check(launches["ell_scatter_add_"] > 0,
          "the window path never launched K1's compact form")
    check(launches["ell_scatter"] == 0,
          "the window path launched K1's dense form")
    log(f"window: accepted {accepted}, rejected {out['rejected']}, median "
        f"{out['median_advance_s']:.3f} s/advance, escalated to the direct "
        f"rescue {driver.n_escalated}, K1 launches {launches} "
        f"({out['k1_launches_per_advance']:.1f} per advance); {card}")
    return out, model, moved


def distance1_coloring(mm, nn, n_dofs):
    """Greedy colouring in which only adjacent nodes differ: too weak for
    column probing (the control of the rescue's check (b))."""
    import numpy as np

    order = np.argsort(mm, kind="stable")
    nn_s = nn[order]
    starts = np.searchsorted(mm[order], np.arange(n_dofs + 1))
    colors = np.full(n_dofs, -1, dtype=np.int64)
    for v in range(n_dofs):
        taken = {colors[u] for u in nn_s[starts[v]:starts[v + 1]]}
        c = 0
        while c in taken:
            c += 1
        colors[v] = c
    return colors


def rescue(k1, card, model, moved) -> dict:
    """Phase rescue: the host sparse-direct Newton on the fresh window's
    moved state (tools/port_reference_options.py)."""
    import dataclasses

    import numpy as np

    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.solvers.direct import (DirectNewton,
                                               build_adjacency_pairs)
    from fedm_tpu_torch.timestepping import AdaptiveDriver

    ref = REF_RESCUE
    out = {}
    sys_ = model.system
    n_dofs = sys_.n_dofs
    # (a) the colouring and the sparsity pattern
    dn = DirectNewton(sys_, rtol=1e-3)
    out.update(n_colors=dn.n_colors, n_pairs=dn.n_pairs,
               probes_per_factorization=dn.n_colors * sys_.n_eq)
    log(f"rescue: {dn.n_colors} colours, {dn.n_pairs} node pairs "
        f"(JAX {ref['n_colors']}, {ref['n_pairs']})")
    check((dn.n_colors, dn.n_pairs) == (ref["n_colors"], ref["n_pairs"]),
          "the colouring or the node pairs differ from the JAX package's")

    # (b) the probed Jacobian against the matrix-free J v
    params = StepParams(moved.t + moved.dt, moved.dt, moved.dt_old)
    ops = sys_.operators(moved.u, moved.u_old1, params)
    delta = torch.zeros((n_dofs, sys_.n_eq), dtype=sys_.dtype,
                        device=moved.u.device)
    jvp = ops.jacobian_action(delta)
    mm, nn = build_adjacency_pairs(sys_.cell_batch.dofs_np, n_dofs)
    weak_dn = DirectNewton(sys_)
    weak_dn.prepare(colors=distance1_coloring(mm, nn, n_dofs))
    gen = torch.Generator().manual_seed(0)
    vs = [torch.randn((n_dofs, sys_.n_eq), generator=gen) for _ in range(3)]
    mf = [jvp(v.to(moved.u.device)).double().cpu().numpy().reshape(-1)
          for v in vs]

    def gaps(J):
        return [float(np.linalg.norm(J @ v.double().numpy().reshape(-1) - y)
                      / np.linalg.norm(y)) for v, y in zip(vs, mf)]

    torch.cuda.synchronize()
    t = time.perf_counter()
    J = dn.assemble(ops, delta)
    out["assemble_s"] = time.perf_counter() - t
    out["jv_rel"] = gaps(J)
    out["jv_rel_distance1_control"] = gaps(weak_dn.assemble(ops, delta))
    log(f"probed J v vs matrix-free: {out['jv_rel']} (limit "
        f"{RESCUE_JV_RTOL:g}); distance-1 control "
        f"{out['jv_rel_distance1_control']} ({weak_dn.n_colors} colours); "
        f"assembly {out['assemble_s']:.2f} s, nnz {J.nnz}")
    check(max(out["jv_rel"]) <= RESCUE_JV_RTOL,
          "the probed Jacobian disagrees with the matrix-free J v")
    check(min(out["jv_rel_distance1_control"]) > RESCUE_JV_RTOL,
          "a distance-1 colouring passes the J v check: it cannot tell a "
          "wrong colouring")

    # (c) one advance whose primary Newton cannot converge
    base = sys_.newton

    def weak_advance(hi_residual: bool):
        sys_.newton = dataclasses.replace(base, **RESCUE_WEAK,
                                          hi_residual=hi_residual)
        fallback = DirectNewton(sys_, rtol=1e-3)
        histories = []
        step = fallback.step

        def recorded(*a):
            res = step(*a)
            histories.append(list(fallback.history))
            return res

        fallback.step = recorded
        cfg = model.cfg
        driver = AdaptiveDriver(
            sys_, monitor_idx=1, ttol=cfg.ttol, dt_min=cfg.dt_min,
            dt_max=cfg.dt_max, post_accept=model.floor_projection(),
            fail_dt_cap=0.7, predictor=1.0, fallback_system=fallback)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s1 = driver.advance(moved)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        du = (s1.u - moved.u).cpu().numpy()
        return s1, driver, fallback, histories, wall, [
            float(np.linalg.norm(du[:, k])) for k in range(du.shape[1])]

    try:
        k1.LAUNCHES.clear()
        s1, driver, fb, histories, wall, inc = weak_advance(True)
        launches = k1_launches(k1)
        ctl = weak_advance(False)
    finally:
        sys_.newton = base
    flat = [f for h in histories for f in h]
    ref_flat = [f for h in ref["direct_history"] for f in h]
    out.update({
        "advance_s": wall, "accepted": s1.n_accepted - moved.n_accepted,
        "rejected": s1.n_rejected - moved.n_rejected,
        "escalated": driver.n_escalated,
        "factorizations": fb.n_factorizations, "probes": fb.n_probes,
        "probe_s": fb.probe_s, "splu_s": fb.factor_s, "nnz": fb.nnz,
        "direct_history": histories, "increment_norms": inc,
        "launches": launches, "t": s1.t, "dt": s1.dt, "card": card})
    log(f"rescue advance {wall:.2f} s: accepted {out['accepted']}, "
        f"rejected {out['rejected']}, escalated {driver.n_escalated}, "
        f"{fb.n_factorizations} factorizations x "
        f"{out['probes_per_factorization']} probes, probing "
        f"{fb.probe_s:.2f} s, splu {fb.factor_s:.2f} s, nnz {fb.nnz}, "
        f"K1 launches {launches}")
    check(out["accepted"] == 1, "the rescued advance was not accepted")
    check(driver.n_escalated >= 1, "the advance never escalated")
    check((driver.n_escalated, out["rejected"], fb.n_factorizations,
           [len(h) for h in histories]) == (
        ref["escalated"], ref["rejected"], ref["factorizations"],
        [len(h) for h in ref["direct_history"]]),
        "escalations, rejections, factorizations or direct iterations "
        "differ from the JAX package's")
    tols = [RESCUE_HISTORY_RTOL[min(i, len(RESCUE_HISTORY_RTOL) - 1)]
            for h in ref["direct_history"] for i in range(len(h))]
    out["history_rel"] = held_to("direct ||F|| per iteration", flat,
                                 ref_flat, tols)
    out["increment_rel"] = held_to("per-equation ||u_new - u_old||", inc,
                                   ref["increment_norms"],
                                   RESCUE_INCREMENT_RTOL)
    check(launches["ell_scatter_add_"] > 0,
          "the rescue never launched K1's compact form")
    # the control: the line search on the float32 residual
    c_flat = [f for h in ctl[3] for f in h]
    c_rel = _rel(c_flat[:len(ref_flat)], ref_flat) if len(
        c_flat) >= len(ref_flat) else None
    c_inc = _rel(ctl[5], ref["increment_norms"])
    out["control_f32_line_search"] = {"history_rel": c_rel,
                                      "increment_rel": c_inc,
                                      "history": ctl[3]}
    log(f"control (float32 residual in the line search): history "
        f"{ctl[3]}, rel. {c_rel}; increments rel. {c_inc}")
    check(c_rel is None or any(r > tol for r, tol in zip(c_rel, tols)),
          "the float32 line search passes the history tolerance")
    check(any(r > tol for r, tol in zip(c_inc, RESCUE_INCREMENT_RTOL)),
          "the float32 line search passes the increment tolerance")
    return out


def write_streamer_tree(base: Path) -> Path:
    """tests/unit/test_streamer_file_input.py's reference-format tree: the
    Bagheri closed forms as `fun:E` expressions, LFA."""
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
        (tc / f"{sp}_Nb.dat").write_text(header.format(dep="const")
                                         + "0.0\n")
        (tc / f"{sp}_ND.dat").write_text(header.format(dep="const")
                                         + "0.0\n")
    (tc / "alpha.dat").write_text(
        header.format(dep="fun:E")
        + "(1.1944e6 + 4.3666e26 * E_m**(-3))*exp(-2.73e7/E_m)-340.75\n")
    return base


def column_stats(x, v) -> list:
    """Per-column 2-norms, then per-column dots with `v` (numpy)."""
    x = x.double().cpu().numpy()
    return ([float((x[:, k] ** 2).sum() ** 0.5) for k in range(3)]
            + [float(x[:, k] @ v[:, k]) for k in range(3)])


def options(k1, card) -> dict:
    """Phase options: the JAX package's default StreamerConfig through
    `from_file_input`, its preconditioner flavours and one advance of each
    option (tools/port_reference_options.py)."""
    import tempfile

    import numpy as np

    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.solvers import newton

    ref = REF_OPTIONS
    out = {"card": card}
    r_np = np.random.default_rng(0).standard_normal((ref["n_dofs"], 3))
    v_np = np.random.default_rng(1).standard_normal((ref["n_dofs"], 3))

    def flat_ref(stats):
        return stats["norms"] + stats["dots"]

    with tempfile.TemporaryDirectory() as tmp:
        tree = write_streamer_tree(Path(tmp))
        t = time.perf_counter()
        models = {name: StreamerModel.from_file_input(
            tree, device="cuda", **kw) for name, kw in OPTION_CONFIGS.items()}
        control = StreamerModel.from_file_input(tree, device="cuda",
                                                dtype=torch.float32)
        built_in = StreamerModel(StreamerConfig(), device="cuda")
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t
    mg = models["mg"]
    n_dofs = mg.space.n_dofs
    log(f"options: {len(models) + 2} models of {n_dofs} dofs "
        f"({3 * n_dofs} unknowns) built in {out['build_s']:.2f} s")
    check(n_dofs == ref["n_dofs"] and mg.cfg.poisson_precond == "mg"
          and mg.SIGN == (1.0, -1.0), "the file-input model is not the "
                                      "JAX default")
    E = torch.tensor([1e3, 3e5, 2.5e6, 1.2e7], dtype=torch.float64,
                     device="cuda")
    for name in ("_mu_e", "_D_e", "_alpha"):
        check(torch.equal(getattr(mg, name)(E_m=E),
                          getattr(built_in, name)(E_m=E)),
              f"the compiled {name} differs from the built-in expression")
    # the same arithmetic: the initial states (the levels' setup sums
    # through K1 in a fixed order, F3) and the residuals at one state are
    # the same bits
    s0, sb = mg.initial_state(), built_in.initial_state()
    p0 = StepParams(sb.dt, sb.dt, sb.dt_old)
    check(torch.equal(s0.u, sb.u) and torch.equal(
        mg.system.residual(sb.u, sb.u, sb.u_old1, p0),
        built_in.system.residual(sb.u, sb.u, sb.u_old1, p0)),
        "the file-input model's initial state or residual differs from "
        "the built-in model's")
    log("file input: the compiled expressions, the initial state and the "
        "initial residual equal the built-in model's, bit for bit")
    del built_in

    def precond_stats(model, dtype):
        s = model.initial_state()
        ops = model.system.operators(s.u, s.u_old1, StepParams(
            s.dt, s.dt, s.dt_old))
        delta = torch.zeros_like(s.u, dtype=dtype)
        M = model.system.block_precond_builder(ops)(delta)
        r = torch.as_tensor(r_np, dtype=dtype, device="cuda")
        return column_stats(M(r), v_np), ops, delta

    out["precond_rel"] = {}
    for name in ("mg", "zline", "tzline"):
        got, ops, delta = precond_stats(models[name], torch.float64)
        out["precond_rel"][name] = held_to(
            f"M r {name} (norms, dots)", got,
            flat_ref(ref["precond"][name]), [OPTIONS_PRECOND_RTOL] * 6)
        if name == "mg":
            out["row_weights_rel"] = held_to(
                "row weights (norms, dots)",
                column_stats(mg.system.row_weights(ops, delta), v_np),
                flat_ref(ref["row_weights"]), [OPTIONS_PRECOND_RTOL] * 6)
    out["precond_f32_rel"] = refused_by(
        "M r mg of the float32 model", precond_stats(control,
                                                     torch.float32)[0],
        flat_ref(ref["precond"]["mg"]), [OPTIONS_PRECOND_RTOL] * 6)
    del control

    counts = {}
    patches = {name: counting(counts, name, getattr(newton, name))
               for name in ("newton_iteration", "bicgstab", "gmres")}
    out["advance"] = {}
    for name, model in models.items():
        model.system.use_gather_scatter()
        s = model.initial_state()
        counts.clear()
        k1.LAUNCHES.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mock.patch.multiple(newton, **patches):
            s1 = model.make_driver().advance(s)
        torch.cuda.synchronize()
        rec = {"advance_s": time.perf_counter() - t,
               "accepted": s1.n_accepted, "rejected": s1.n_rejected,
               "dt": s1.dt, "t": s1.t, "error": s1.max_error[0],
               "iterations": dict(counts), "launches": k1_launches(k1)}
        jr = ref["advance"][name]
        rec["dt_rel"] = abs(rec["dt"] - jr["dt"]) / jr["dt"]
        rec["error_rel"] = abs(rec["error"] - jr["error"]) / jr["error"]
        out["advance"][name] = rec
        log(f"options advance {name}: {rec['advance_s']:.2f} s, accepted/"
            f"attempted {rec['accepted']}/{rec['accepted'] + rec['rejected']}"
            f", iterations {rec['iterations']} (JAX {jr['iterations']}), "
            f"dt {rec['dt']:.6e} (rel. {rec['dt_rel']:.2e}), step error "
            f"rel. {rec['error_rel']:.2e}, K1 {rec['launches']}")
        check((rec["accepted"], rec["rejected"]) == (jr["accepted"],
                                                    jr["rejected"]),
              f"options {name}: accepted/rejected differ from the JAX "
              f"package's")
        # float64: the counts inside the range the JAX package's own
        # counts take under 1e-12 perturbations of the state; where that
        # range is one number, the counts are the JAX package's. float32:
        # the same outcome and step error; the counts are reported
        for key, (lo, hi) in jr.get("spread", {}).items():
            check(lo <= rec["iterations"].get(key, 0) <= hi,
                  f"options {name}: {key} {rec['iterations'].get(key, 0)} "
                  f"outside the JAX package's {lo}-{hi}")
        check("spread" not in jr or rec["iterations"].get("gmres", 0)
              == jr["iterations"].get("gmres", 0),
              f"options {name}: GMRES iterations differ")
        tol = OPTIONS_STEP_RTOL[name.endswith("f32")]
        check(rec["dt_rel"] <= tol and rec["error_rel"] <= tol,
              f"options {name}: dt or step error off the JAX package's")
        check(bool(torch.isfinite(s1.u).all()), f"options {name}: "
                                                "non-finite state")
        check(rec["launches"]["ell_scatter_add_"] > 0,
              f"options {name}: K1's compact form never ran")
        if name.endswith("f32"):
            counts.clear()
            with mock.patch.multiple(newton, **patches):
                s2 = model.make_driver().advance(s)
            rec["repeat_iterations"] = dict(counts)
            rec["repeat_bitwise"] = bool(torch.equal(s1.u, s2.u))
            log(f"options advance {name} again: iterations {counts}, the "
                f"same state bit for bit: {rec['repeat_bitwise']}")
            check(rec["repeat_iterations"] == rec["iterations"]
                  and rec["repeat_bitwise"],
                  f"options {name}: a second advance from the same state "
                  f"differs")
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

        # the segment sums are deterministic (F3): two V-cycles of one
        # vector, and two advances from one state by two fresh drivers,
        # give the same bits
        solve = model.system._ell[1]
        r = torch.randn(n_dofs, device="cuda", dtype=model.batch.dtype,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(5))
        k1.LAUNCHES.clear()
        z1, z2 = solve(r), solve(r)
        out["vcycle_launches"] = k1_launches(k1)
        check(torch.equal(z1, z2), "two V-cycles of one vector differ")
        check(out["vcycle_launches"]["ell_scatter"] > 0,
              "the glow's V-cycle never launched K1's dense form")
        state.dt = min(state.dt, max(args.T - state.t, model.cfg.dt_min))
        twin = build_driver(args, model, fallback).advance(
            state, model._update_aux(state.u))
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
                if twin is not None:
                    out["advance_bitwise"] = bool(
                        torch.equal(state.u, twin.u) and state.dt == twin.dt)
                    check(out["advance_bitwise"], "two glow advances from "
                                                  "one state differ")
                    twin = None
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


def tof_k1_cases(k1, flush) -> list:
    """K1 at the ToF shapes, float64, C = 1: the dense cell tables of the
    1D P2 mesh (4,000 cells, 8,001 rows x 2 slots) and the 2D P1 mesh
    (40 x 40, 1,681 rows x 6 slots), built by the port's own
    `build_ell_index`; both forms (the new tensor of `project` and the
    in-place rows=None of every residual, J v and node-block build)
    against their plain versions, timed cold beside `index_add_`, the
    empty-kernel floor and the byte bound."""
    from fedm_tpu_torch.fem import FunctionSpace
    from fedm_tpu_torch.fem.assembly import build_ell_index
    from fedm_tpu_torch.mesh import interval_mesh, rectangle_mesh

    gen = torch.Generator(device="cuda").manual_seed(9)
    spaces = {"tof 1d P2": (FunctionSpace(interval_mesh(4000, 0.0, 1e-3), 2),
                            (8001, 2)),
              "tof 2d P1": (FunctionSpace(rectangle_mesh(
                  (0, 0), (2.5e-4, 5e-4), 40, 40), 1), (1681, 6))}
    cases = []
    for name, (space, shape) in spaces.items():
        idx = torch.as_tensor(build_ell_index(space.cell_dofs, space.n_dofs),
                              device="cuda")
        check(tuple(idx.shape) == shape, f"K1 {name}: table "
                                         f"{tuple(idx.shape)}, not {shape}")
        dofs = torch.as_tensor(space.cell_dofs.reshape(-1), dtype=torch.long,
                               device="cuda")
        flat = torch.randn((space.cell_dofs.size, 1), generator=gen,
                           device="cuda", dtype=torch.float64)
        cases.append(k1_case(f"{name} C=1 float64", idx, flat,
                             k1.ell_scatter, k1.ell_scatter_ref, flush))
        # the empty-kernel floor of these grids is timed here too
        cases.append(k1_compact_case(
            f"{name} dense in place C=1 float64", None, idx, idx, dofs, flat,
            space.n_dofs, k1, gen, flush))
    return cases


def tof(k1, card) -> dict:
    """Phase 7: the time-of-flight verification runs on the card, held to
    the JAX package's numbers (tools/port_reference_tof.py)."""
    import tempfile

    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.tof import (TimeOfFlight1D, TimeOfFlight2D,
                                           TofConfig)

    out = {"card": card}

    def norm(x):
        return float(torch.linalg.vector_norm(x.double()))

    def run(model, output_times):
        k1.LAUNCHES.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        u, errors = model.run(output_times=output_times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(bool(torch.isfinite(u).all()), "non-finite ToF state")
        return u, errors, wall, k1_launches(k1)

    # 1D at full width: 4,000 P2 cells, 10 steps
    ref = REF_TOF["1d"]
    m1 = TimeOfFlight1D(TofConfig(dt=1e-11, T_final=1e-10), n_cells=4000)
    c = m1.cfg
    check(m1.space.n_dofs == ref["n_dofs"], f"{m1.space.n_dofs} dofs")
    check(m1.batch.gather_idx is None and m1.batch._structured is None,
          "the ToF batch was switched to another scatter layout")
    u0 = m1.initial_state()
    p0 = StepParams(c.t0 + c.dt, c.dt, 1e30)
    out["1d_initial_state_rel"] = held_to(
        "tof 1d initial state norm", [norm(u0)],
        [ref["initial_state_norm"]], [TOF_STATE_RTOL])
    out["1d_initial_state_f32_rel"] = refused_by(
        "tof 1d initial state rounded to float32", [norm(u0.float())],
        [ref["initial_state_norm"]], [TOF_STATE_RTOL])
    F = m1.system.residual(u0, u0, u0, p0)
    out["1d_initial_residual_rel"] = held_to(
        "tof 1d first f64 residual norm", [norm(F)],
        [ref["initial_residual_norm"]], [TOF_RESIDUAL_RTOL])
    out["1d_initial_residual_f32_rel"] = refused_by(
        "tof 1d first f32 residual norm",
        [norm(m1.system.residual(u0, u0, u0, p0, torch.float32))],
        [ref["initial_residual_norm"]], [TOF_RESIDUAL_RTOL])
    with mock.patch("fedm_tpu_torch.fem.assembly.ell_scatter_add_",
                    k1.ell_scatter_add_ref):
        F_plain = m1.system.residual(u0, u0, u0, p0)
    out["1d_residual_k1_vs_plain"] = norm(F - F_plain) / norm(F_plain)
    check(out["1d_residual_k1_vs_plain"] <= 1e-13,
          "K1 in the ToF residual disagrees with the plain scatter")
    u, errors, wall, launches = run(m1, [c.T_final])
    iters = [int(i.iters) for i in m1.step_infos]
    out.update({"1d_s": wall, "1d_newton_iterations": iters,
                "1d_errors": errors, "1d_launches": launches})
    log(f"tof 1d: 10 steps in {wall:.2f} s, Newton iterations {iters} "
        f"(JAX {ref['newton_iterations']}), K1 {launches}")
    check(iters == ref["newton_iterations"],
          "tof 1d: Newton iterations differ from the JAX package's")
    out["1d_error_rel"] = held_to("tof 1d relative L2 error at 1e-10",
                                  [e for _, e in errors],
                                  [e for _, e in ref["errors"]],
                                  [TOF_ERROR_RTOL])
    out["1d_error_one_step_early_rel"] = refused_by(
        "tof 1d error against the exact solution one step early",
        [m1.relative_l2_error(u, errors[-1][0] - c.dt)],
        [ref["errors"][-1][1]], [TOF_ERROR_RTOL])
    check(launches["ell_scatter_add_"] > 0 and launches["ell_scatter"] > 0,
          "tof 1d never launched K1's dense forms")
    del m1, u, u0, F, F_plain

    # 2D: the reference configuration, or its first 20 steps where the
    # budget left is short
    ref = REF_TOF["2d"]
    left = BUDGET_S - (time.perf_counter() - T0)
    n2 = (TOF_2D_STEPS_FULL if left >= TOF_2D_FULL_RESERVE_S
          else TOF_2D_STEPS_CUT)
    log(f"tof 2d: {left:.0f} s of the budget left: {n2} steps")
    cfg2 = TofConfig(t0=2.5e-9, T_final=2.5e-9 + n2 * 1e-12, dt=1e-12)
    m2 = TimeOfFlight2D(cfg2)
    check(m2.space.n_dofs == ref["n_dofs"], f"{m2.space.n_dofs} dofs")
    outs = [t for t, _ in ref["errors"][:1 + (n2 == TOF_2D_STEPS_FULL)]]
    u, errors, wall, launches = run(m2, outs)
    iters = [int(i.iters) for i in m2.step_infos]
    out.update({"2d_steps": n2, "2d_s": wall,
                "2d_newton_iterations": iters, "2d_errors": errors,
                "2d_launches": launches})
    log(f"tof 2d: {n2} steps in {wall:.2f} s, Newton iterations "
        f"{collections.Counter(iters)}, K1 {launches}")
    check(iters == ref["newton_iterations"][:n2],
          "tof 2d: Newton iterations differ from the JAX package's")
    out["2d_error_rel"] = held_to(
        "tof 2d relative L2 errors", [e for _, e in errors],
        [e for _, e in ref["errors"][:len(errors)]],
        [TOF_ERROR_RTOL] * len(errors))
    out["2d_error_one_step_early_rel"] = refused_by(
        "tof 2d error against the exact solution one step early",
        [m2.relative_l2_error(u, errors[-1][0] - cfg2.dt)],
        [ref["errors"][len(errors) - 1][1]], [TOF_ERROR_RTOL])
    if n2 == TOF_2D_STEPS_FULL:
        out["2d_pinned_rel"] = _rel([errors[-1][1]], [TOF_PINNED_L2])[0]
        log(f"tof 2d error {errors[-1][1]!r} vs the reference's pinned "
            f"{TOF_PINNED_L2}: rel. {out['2d_pinned_rel']:.3e}")
        check(out["2d_pinned_rel"] <= TOF_PINNED_RTOL,
              "tof 2d error off the reference's pinned value")
    check(launches["ell_scatter_add_"] > 0 and launches["ell_scatter"] > 0,
          "tof 2d never launched K1's dense forms")
    del m2, u

    # the entry point, as a user runs it, on the card
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fedm_tpu_torch.examples.tof_1d",
             "--quick", "-o", tmp], capture_output=True, text=True,
            cwd=ROOT, timeout=max(60, BUDGET_S - (time.perf_counter() - T0)))
        out["quick_s"] = time.perf_counter() - t
        check(proc.returncode == 0, f"tof_1d --quick failed: {proc.stderr}")
        tree = sorted(str(p.relative_to(tmp)) for p in Path(tmp).rglob("*")
                      if p.is_file())
        check(tree == [
            "mesh/mesh info.txt", "mesh/mesh.vtu", "model.log",
            "number density/analytical solution/analytical solution.pvd",
            "number density/analytical solution/"
            "analytical solution000000.vtu",
            "number density/electrons/electrons.pvd",
            "number density/electrons/electrons000000.vtu",
            "relative error.log"], f"tof_1d --quick wrote {tree}")
        lines = (Path(tmp) / "relative error.log").read_text().splitlines()
        rows = [re.fullmatch(r"h_max = (\S+)\t dt = (\S+)\t "
                             r"relative_error = (\S+)", line)
                for line in lines]
        check(len(rows) == 3 and all(
            r is not None and abs(float(r[1]) / 2.5e-6 - 1) < 1e-12
            and r[2] == "1e-11" for r in rows),
            f"relative error.log: {lines}")
        got = [float(r[3]) for r in rows]
    out["quick_errors"] = got
    out["quick_error_rel"] = held_to(
        "tof_1d --quick relative error.log", got,
        [e for _, e in REF_TOF["quick"]["errors"]], [TOF_ERROR_RTOL] * 3)
    log(f"tof_1d --quick on the card in {out['quick_s']:.2f} s (a process "
        f"of its own, the kernel build loaded from the cache): "
        f"{proc.stdout.strip().splitlines()[-1]}")
    return out


def extended_models(tmp: Path, n_parts: int = EXT_PARTS):
    """The extended scheme of `python -m
    fedm_tpu_torch.examples.extended_scheme` at its defaults (18 species,
    crossed 32 x 64, float64) on a tree generated into `tmp`: the
    undistributed model, and a second one distributed over `n_parts`
    parts on the card, with its DistributedSystem."""
    from fedm_tpu_torch.examples import extended_scheme
    from fedm_tpu_torch.models.argon_synth import generate_argon_n_input

    root = generate_argon_n_input(tmp, n_excited=EXT_SPECIES - 5)
    args = extended_scheme.parse_args([])
    m = extended_scheme.build_model(args, tmp, root.name)
    md = extended_scheme.build_model(args, tmp, root.name)
    return m, md, md.distribute(["cuda"] * n_parts)


def extended_k1_cases(k1, flush) -> list:
    """K1 at the extended scheme's shapes, float64: the stacked DD tables'
    compact form (their live rows; the padded elements have no slot), the
    cell table at C = 19 (residual and J v) and C = 361 (node blocks), the
    facet table at C = 19, and `ell_scatter` at C = 1 on the
    undistributed cell table (the aux update's `project`); each against
    its plain version, timed cold beside `index_add_`, the empty-kernel
    floor and the byte bound."""
    import tempfile

    from fedm_tpu_torch.fem.assembly import build_ell_index

    gen = torch.Generator(device="cuda").manual_seed(10)
    with tempfile.TemporaryDirectory() as tmp:
        m, _, d = extended_models(Path(tmp))
    cb, fb = d._batches[0][0], d._batches[1][0]
    rows = d.n_parts * d.n_ext
    cases = []
    idx = torch.as_tensor(build_ell_index(m.batch.dofs_np, m.batch.n_dofs),
                          device="cuda")
    flat = torch.randn((m.batch.dofs.numel(), 1), generator=gen,
                       device="cuda", dtype=torch.float64)
    cases.append(k1_case("extended cell C=1 float64", idx, flat,
                         k1.ell_scatter, k1.ell_scatter_ref, flush))
    # the DD tables as the path scatters through them: their live rows
    # (the trash and phantom rows never are), no slot for padded elements
    for name, b, C in (("extended dd cell", cb, 19),
                       ("extended dd cell", cb, 361),
                       ("extended dd facet", fb, 19)):
        check(b.scatter_rows is not None, f"the {name} table is not "
                                          f"compact")
        flat = torch.randn((b.dofs.numel(), C), generator=gen,
                           device="cuda", dtype=torch.float64)
        zero_pads(flat, b, d.n_ext)
        cases.append(k1_compact_case(
            f"{name} compact C={C} float64", b.scatter_rows, b.scatter_idx,
            b.gather_idx, b.dofs.reshape(-1).long(), flat, rows, k1, gen,
            flush))
    return cases


def _close(name, got, ref, rtol, atol=0.0, atol_rel=0.0) -> float:
    """The largest |got - ref| / (atol + atol_rel * max|ref| + rtol |ref|):
    at most 1 where `got` holds to `ref`."""
    ref = ref.double()
    err = (got.double() - ref).abs()
    lim = atol + atol_rel * float(ref.abs().max()) + rtol * ref.abs()
    ratio = float((err / lim).max())
    log(f"{name}: max |a - b| / (atol + rtol |b|) = {ratio:.3e} (rtol "
        f"{rtol:g}, atol {atol:g} + {atol_rel:g} * max)")
    return ratio


def extended(k1, card) -> dict:
    """Phase 8: the extended reaction scheme under the DOF-partitioned
    domain decomposition, held to tools/port_reference_extended.py's JAX
    numbers."""
    import tempfile

    import numpy as np

    from fedm_tpu_torch.mesh.reorder import cell_adjacency_csr
    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.native import native_available, partition_graph
    from fedm_tpu_torch.solvers import newton

    ref = REF_EXTENDED
    out = {"card": card}

    def norms(x):
        x = x.reshape(x.shape[0], -1).double()
        return [float(torch.linalg.vector_norm(x[:, k]))
                for k in range(x.shape[1])]

    def row_norms(B):
        return [float(torch.linalg.vector_norm(B[:, i, :].double()))
                for i in range(B.shape[1])]

    # (1) the partitioner
    check(native_available(), "the native partitioner did not build")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        m, md, d = extended_models(Path(tmp))
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    part = partition_graph(*cell_adjacency_csr(m.mesh), EXT_PARTS)
    out["partition_s"] = time.perf_counter() - t
    rp = ref["partition"]
    got = {"part_checksum": int(np.sum((np.arange(len(part)) + 1)
                                       * part.astype(np.int64))),
           "part_sizes": np.bincount(part, minlength=EXT_PARTS).tolist(),
           "n_own_max": d.n_own_max, "n_ghost_max": d.n_ghost_max,
           "shifts": list(d._shifts)}
    out["partition"] = got
    log(f"extended: native partition of {m.mesh.n_cells} cells into "
        f"{EXT_PARTS} parts in {out['partition_s'] * 1e3:.1f} ms: {got} "
        f"(JAX {rp})")
    check(np.array_equal(part, d.cell_part), "the DD's partition differs")
    for key, val in got.items():
        check(val == rp[key], f"extended partition: {key} {val} differs "
                              f"from the JAX package's {rp[key]}")

    # (2) the model's size
    rm = ref["model"]
    size = {"n_species": m.n_species, "n_eq": m.n_eq,
            "n_dofs": m.space.n_dofs,
            "unknowns": m.space.n_dofs * m.n_eq,
            "n_reactions": int(m.P_mat.shape[0]), "species": list(m.species)}
    out["model"] = {k: v for k, v in size.items() if k != "species"}
    log(f"extended model: {out['model']}, built (twice, one distributed) "
        f"in {out['build_s']:.2f} s")
    for key, val in size.items():
        check(val == rm[key], f"extended model: {key} {val} differs from "
                              f"the JAX package's {rm[key]}")

    # (3) residual and node blocks, distributed and not
    ri = ref["initial"]
    s, sd = m.initial_state(), md.initial_state()
    out["state_rel"] = held_to("extended initial state norms", norms(s.u),
                               ri["state_norms"], [EXT_STATE_RTOL] * m.n_eq)
    check(np.array_equal(d.from_dist(sd.u), s.u.cpu().numpy()),
          "the distributed initial state differs from the undistributed")
    aux, auxd = m._update_aux(s.u), md._update_aux(sd.u)
    p = StepParams(*ri["params"])
    F = m.system.residual(s.u, s.u, s.u_old1, p, aux=aux)
    Fd = md.system.residual(sd.u, sd.u, sd.u_old1, p, aux=auxd)
    Fg = Fd[d._slot_of_t]
    z = torch.zeros_like(s.u)
    B = m.system.operators(s.u, s.u_old1, p, aux=aux).jacobian_blocks(z)
    Bd = md.system.operators(sd.u, sd.u_old1, p, aux=auxd).jacobian_blocks(
        torch.zeros_like(sd.u))
    Bg = Bd[d._slot_of_t]
    out["residual_rel"] = held_to(
        "extended f64 residual norms", norms(F), ri["residual_norms"],
        EXT_RESIDUAL_RTOL)
    out["dist_residual_rel"] = held_to(
        "extended distributed f64 residual norms", norms(Fg),
        ri["residual_norms"], EXT_RESIDUAL_RTOL)
    out["blocks_rel"] = held_to(
        "extended node-block row norms", row_norms(B),
        ri["block_row_norms"], [EXT_BLOCKS_RTOL] * m.n_eq)
    out["dist_blocks_rel"] = held_to(
        "extended distributed node-block row norms", row_norms(Bg),
        ri["block_row_norms"], [EXT_BLOCKS_RTOL] * m.n_eq)
    out["dist_vs_undist_residual"] = _close(
        "extended residual, 8 parts vs undistributed", Fg, F,
        EXT_OPS_RTOL, atol_rel=EXT_OPS_ATOL_REL)
    out["dist_vs_undist_blocks"] = _close(
        "extended node blocks, 8 parts vs undistributed", Bg, B,
        EXT_OPS_RTOL, atol_rel=EXT_OPS_ATOL_REL)
    check(out["dist_vs_undist_residual"] <= 1.0
          and out["dist_vs_undist_blocks"] <= 1.0,
          "the distributed residual or blocks differ from the undistributed")
    phantom = torch.as_tensor(np.setdiff1d(np.arange(d.n_dofs_dist),
                                           d._slot_of), device="cuda")
    eye = torch.eye(m.n_eq, dtype=Bd.dtype, device="cuda")
    check(not bool(Fd[phantom].any())
          and bool((Bd[phantom] == eye).all()),
          "phantom rows are not identity rows")
    # controls: the reverse exchange skipped, and the residual in float32
    with mock.patch.object(d, "_halo_reduce", lambda r: r.reshape(
            (d.n_parts, d.n_ext) + tuple(r.shape[1:]))[:, :d.n_own_max]
            .reshape((d.n_dofs_dist,) + tuple(r.shape[1:]))):
        Fc = md.system.residual(sd.u, sd.u, sd.u_old1, p, aux=auxd)
    out["control_no_reverse_exchange"] = _close(
        "extended residual without the reverse exchange (control)",
        Fc[d._slot_of_t], F, EXT_OPS_RTOL, atol_rel=EXT_OPS_ATOL_REL)
    check(out["control_no_reverse_exchange"] > 1.0,
          "the residual without the reverse exchange passes the tolerance")
    out["control_no_reverse_exchange_rel"] = refused_by(
        "extended residual norms without the reverse exchange",
        norms(Fc[d._slot_of_t]), ri["residual_norms"], EXT_RESIDUAL_RTOL)
    out["control_f32_rel"] = refused_by(
        "extended f32 residual norms", norms(m.system.residual(
            s.u, s.u, s.u_old1, p, torch.float32, aux=aux)),
        ri["residual_norms"], EXT_RESIDUAL_RTOL)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(m.space.n_dofs, generator=gen, device="cuda",
                    dtype=torch.float64)
    eq = m.n_eq - 1
    y = m.system.masked_stiffness_op(eq)(x)
    yd = d._dist_stiffness_op(eq)(d.to_dist(x))[d._slot_of_t]
    out["stiffness_op"] = _close("extended _dist_stiffness_op vs "
                                 "masked_stiffness_op", yd, y, EXT_OPS_RTOL,
                                 atol_rel=EXT_OPS_ATOL_REL)
    with mock.patch.object(d, "_halo_reduce", lambda r: r.reshape(
            (d.n_parts, d.n_ext) + tuple(r.shape[1:]))[:, :d.n_own_max]
            .reshape((d.n_dofs_dist,) + tuple(r.shape[1:]))):
        yc = d._dist_stiffness_op(eq)(d.to_dist(x))[d._slot_of_t]
    out["stiffness_op_control"] = _close(
        "extended _dist_stiffness_op without the reverse exchange "
        "(control)", yc, y, EXT_OPS_RTOL, atol_rel=EXT_OPS_ATOL_REL)
    check(out["stiffness_op"] <= 1.0 < out["stiffness_op_control"],
          "the distributed stiffness operator is off, or its control "
          "passes")
    with mock.patch("fedm_tpu_torch.fem.assembly.ell_scatter_add_",
                    k1.ell_scatter_add_ref):
        F_plain = md.system.residual(sd.u, sd.u, sd.u_old1, p, aux=auxd)
    out["dist_residual_k1_vs_plain"] = _close(
        "extended distributed residual, K1 vs its plain version", Fd,
        F_plain, 1e-13, atol_rel=1e-15)
    check(out["dist_residual_k1_vs_plain"] <= 1.0,
          "K1 in the distributed residual disagrees with the plain scatter")
    del B, Bd, Bg, Fc

    # (4) one step from the initial state, undistributed and on 8 parts
    rs = ref["step"]
    counts = {}
    patches = {name: counting(counts, name, getattr(newton, name))
               for name in ("newton_iteration", "bicgstab", "gmres")}
    steps = {}
    with mock.patch.multiple(newton, **patches):
        for key, model, st in (("undistributed", m, s),
                               ("distributed", md, sd)):
            counts.clear()
            k1.LAUNCHES.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            a = model._update_aux(st.u)
            u1, info = model.system.step(st.u, st.u, st.u_old1, a, p)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            shapes = collections.Counter()
            for (_, table, C, dt), n in k1.LAUNCHES.items():
                shapes[f"{table} C={C} {dt}"] += n
            steps[key] = (u1, info)
            out[f"{key}_step"] = {
                "s": wall, "converged": bool(info.converged),
                "newton_iterations": counts.get("newton_iteration", 0),
                "bicgstab_iterations": counts.get("bicgstab", 0),
                "gmres_iterations": counts.get("gmres", 0),
                "launches": k1_launches(k1),
                "launches_by_shape": dict(sorted(shapes.items()))}
            log(f"extended {key} step: {out[f'{key}_step']} (JAX: Newton "
                f"{rs['newton_iterations']}, BiCGStab "
                f"{rs['bicgstab_iterations']}, under 1e-12 perturbations "
                f"{ref['spread']['bicgstab_iterations']})")
            check(info.converged, f"the extended {key} step did not "
                                  f"converge")
            lo, hi = ref["spread"]["bicgstab_iterations"]
            rec = out[f"{key}_step"]
            check(rec["newton_iterations"] == rs["newton_iterations"]
                  and lo <= rec["bicgstab_iterations"] <= hi
                  and rec["gmres_iterations"] == rs["gmres_iterations"],
                  f"the extended {key} step's counts {rec} lie outside "
                  f"the JAX package's (Newton {rs['newton_iterations']}, "
                  f"BiCGStab {lo}-{hi}, GMRES {rs['gmres_iterations']})")
    out["launches"] = out["distributed_step"]["launches"]
    by_shape = out["distributed_step"]["launches_by_shape"]
    check(by_shape.get("compact C=19 f64", 0) > 0
          and by_shape.get("compact C=361 f64", 0) > 0
          and by_shape.get("dense C=1 f64", 0) > 0,
          f"the distributed step did not launch K1 at its DD shapes: "
          f"{by_shape}")
    u1, u2 = steps["undistributed"][0], steps["distributed"][0][
        d._slot_of_t]
    out["step_dist_vs_undist"] = _close(
        "extended step, 8 parts vs undistributed", u2, u1, EXT_STEP_RTOL,
        atol=EXT_STEP_ATOL)
    check(out["step_dist_vs_undist"] <= 1.0, "the distributed step's state "
          "differs from the undistributed")
    out["step_state_rel"] = held_to(
        "extended step state norms", norms(u2), rs["state_norms"],
        [EXT_STEP_RTOL] * m.n_eq)
    # where the distributed step's time goes: its Krylov loop (most of its
    # wall time) under the profiler for EXT_PROFILED_ITERS BiCGStab
    # iterations of its first Newton iteration, the device events' summed
    # durations against the wall time (one short trace; a whole step's
    # trace took ~45 s to read back)
    from torch.profiler import ProfilerActivity, profile

    from fedm_tpu_torch.solvers.linear import bicgstab

    ops = md.system.operators(sd.u, sd.u_old1, p, aux=md._update_aux(sd.u))
    z = torch.zeros_like(sd.u)
    J, M = ops.jacobian_action(z), md.system.block_precond_builder(ops)(z)
    rhs = M(-ops.residual(z))

    def op(v):
        return M(J(v))

    bicgstab(op, rhs, tol=1e-30, maxiter=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, _, iters = bicgstab(op, rhs, tol=1e-30, maxiter=EXT_PROFILED_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in dev) / 1e6
    out["profiled_krylov"] = {
        "iterations": int(iters), "wall_s": wall, "device_events": len(dev),
        "busy_s": busy if dev else "not measured",
        "idle_share": 1.0 - busy / wall if dev else "not measured"}
    log(f"extended distributed Krylov loop profiled: "
        f"{out['profiled_krylov']}")
    del ops, J, M, rhs
    del m, md, d, s, sd, steps, u1, u2, aux, auxd

    # (5) the entry point as a process: one advance and one more
    re_ = ref["example"]
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fedm_tpu_torch.examples.extended_scheme",
         "--devices", str(EXT_PARTS), "--steps", "1"], capture_output=True,
        text=True, cwd=ROOT,
        timeout=max(60, BUDGET_S - (time.perf_counter() - T0)))
    out["entry_point_s"] = time.perf_counter() - t
    check(proc.returncode == 0, f"extended_scheme failed: {proc.stderr}")
    lines = proc.stdout.strip().splitlines()
    log(f"extended_scheme --devices {EXT_PARTS} --steps 1 in "
        f"{out['entry_point_s']:.1f} s: {lines}")
    mt = re.fullmatch(
        r"(\d+) accepted steps to t=(\S+) \((\d+) rejected\), \S+ s/step, "
        r"ne_max=(\S+) m\^-3, eps_mean=(\S+) eV, finite: (\w+)", lines[-1])
    check(mt is not None and len(lines) == 5,
          f"extended_scheme printed {lines}")
    check(lines[1:3] == re_["lines"], f"extended_scheme's model lines "
          f"{lines[1:3]} differ from the JAX example's {re_['lines']}")
    got = {"accepted": int(mt[1]), "t": float(mt[2]),
           "rejected": int(mt[3]), "ne_max": float(mt[4]),
           "eps_mean": float(mt[5]), "finite": mt[6] == "True"}
    out["entry_point"] = got
    check((got["accepted"], got["rejected"], got["finite"])
          == (re_["accepted"], re_["rejected"], True)
          and lines[-2].startswith("first step (incl. compile): "),
          f"extended_scheme's result {got} differs from the JAX example's "
          f"{re_}")
    # the printed numbers: within one unit of their last printed digit
    for key, unit in (("t", 1e-3 * re_["t"]), ("ne_max", 1e-3 * re_["ne_max"]),
                      ("eps_mean", 0.01)):
        check(abs(got[key] - re_[key]) <= unit, f"extended_scheme's {key} "
              f"{got[key]} differs from the JAX example's {re_[key]}")

    # (6) the streamer's DD at the default StreamerConfig (the options
    # phase's 80 x 160 graded mesh, 13,041 dofs)
    sm = StreamerModel(StreamerConfig(), device="cuda")
    smd = StreamerModel(StreamerConfig(), device="cuda")
    sdd = smd.distribute(["cuda"] * EXT_PARTS)
    s, sd = sm.initial_state(), smd.initial_state()
    ps = StepParams(s.t + s.dt, s.dt, s.dt_old)
    F = sm.system.residual(s.u, s.u, s.u_old1, ps)
    Fg = sdd.residual(sd.u, sd.u, sd.u_old1, ps)[sdd._slot_of_t]
    B = sm.system.operators(s.u, s.u_old1, ps).jacobian_blocks(
        torch.zeros_like(s.u))
    Bg = sdd.operators(sd.u, sd.u_old1, ps).jacobian_blocks(
        torch.zeros_like(sd.u))[sdd._slot_of_t]
    out["streamer"] = {
        "n_dofs": sm.space.n_dofs, "n_own_max": sdd.n_own_max,
        "n_ghost_max": sdd.n_ghost_max, "shifts": list(sdd._shifts),
        "residual": _close("streamer residual, 8 parts vs undistributed",
                           Fg, F, EXT_OPS_RTOL, atol_rel=EXT_OPS_ATOL_REL),
        "blocks": _close("streamer node blocks, 8 parts vs undistributed",
                         Bg, B, EXT_OPS_RTOL, atol_rel=EXT_OPS_ATOL_REL)}
    check(sm.space.n_dofs * 3 == 39123, "the default streamer changed size")
    check(out["streamer"]["residual"] <= 1.0
          and out["streamer"]["blocks"] <= 1.0,
          "the streamer's distributed residual or blocks differ")
    rst = {}
    with mock.patch.multiple(newton, **patches):
        for key, sys_, st in (("undistributed", sm.system, s),
                              ("distributed elliptic", sdd, sd)):
            counts.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if key != "undistributed":
                sdd.enable_distributed_elliptic(2)
            u1, info = sys_.step(st.u, st.u, st.u_old1, {}, ps)
            torch.cuda.synchronize()
            rst[key] = u1
            out["streamer"][f"{key}_step"] = {
                "s": time.perf_counter() - t,
                "converged": bool(info.converged), **dict(counts)}
            check(info.converged, f"the streamer's {key} step did not "
                                  f"converge")
    log(f"streamer DD: {out['streamer']}")
    out["streamer"]["step"] = _close(
        "streamer step, distributed elliptic vs undistributed",
        rst["distributed elliptic"][sdd._slot_of_t], rst["undistributed"],
        EXT_STEP_RTOL, atol=EXT_STEP_ATOL)
    check(out["streamer"]["step"] <= 1.0, "the streamer's distributed "
          "elliptic step differs from the undistributed")
    return out


def zero_pads(flat, b, n_ext: int) -> None:
    """Zero the rows of `flat` [n_elems * n_local, C] that belong to the
    padded elements of a stacked DD batch (every dof in a trash row): their
    contributions are zero on the path (their scale is), the compact table
    gives them no slot, and `index_add_`'s yardstick would sum them."""
    dead = torch.as_tensor((b.dofs_np % n_ext == n_ext - 1).all(axis=1),
                           device=flat.device)
    flat.view(b.dofs.shape[0], -1)[dead] = 0.0


def sweep_k1_cases(k1, flush) -> list:
    """K1 at this slice's new shapes, each against its plain version and
    timed cold beside `index_add_`, the empty-kernel floor and the byte
    bound: the glow's unstructured V-cycle (its second level's table and
    the restriction table between the first two levels, `ell_scatter` at
    C = 1, float32, as the V-cycle calls them; the first level's table is
    the glow cell table, timed above); the batched sweep's stacked tables
    (the default StreamerConfig, B = 8), float64, the cell table in place
    at C = 3 (residual, J v) and C = 9 (node blocks), the facet table's
    compact form at C = 3 and 9; the dd_scale run's stacked tables (280 x
    560 on 8 parts) at the same C, both in their compact form."""
    import numpy as np

    from fedm_tpu_torch.fem import FunctionSpace
    from fedm_tpu_torch.fem.interpolation import restrict_table
    from fedm_tpu_torch.mesh import rectangle_mesh
    from fedm_tpu_torch.model.system import BatchedSystem
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.solvers.multigrid import GeometricMultigrid

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    # the glow50 V-cycle: crossed 64 x 64 over 3 coarsenings
    spaces = [FunctionSpace(rectangle_mesh((0, 0), (0.01, 0.01), n, n,
                                           "crossed")) for n in (64, 32)]
    masks = [np.isclose(sp.dof_coords[:, 1], 0.0)
             | np.isclose(sp.dof_coords[:, 1], 0.01) for sp in spaces]
    mg = GeometricMultigrid(spaces, masks, axisymmetric=True,
                            dtype=torch.float32, device="cuda")
    lev = mg.levels[1]
    flat = torch.randn((lev.batch.dofs.numel(), 1), generator=gen,
                       device="cuda")
    cases.append(k1_case("glow V-cycle level 2 C=1 float32", lev._ell, flat,
                         k1.ell_scatter, k1.ell_scatter_ref, flush))
    idx, table = mg.transfers[0][0], mg.transfers[0][2]
    check(torch.equal(table, restrict_table(idx, spaces[1].n_dofs)),
          "the V-cycle's restriction table")
    flat = torch.randn((idx.numel(), 1), generator=gen, device="cuda")
    cases.append(k1_case("glow restriction 1->2 C=1 float32", table, flat,
                         k1.ell_scatter, k1.ell_scatter_ref, flush))
    del mg

    def stacked(name, cb, fb, rows, n_ext=None):
        """The stacked tables in the form the path scatters through."""
        for b in (cb, fb):
            form = "dense in place" if b.scatter_rows is None else "compact"
            for C in (3, 9):
                flat = torch.randn((b.dofs.numel(), C), generator=gen,
                                   device="cuda", dtype=torch.float64)
                if n_ext is not None:
                    zero_pads(flat, b, n_ext)
                cases.append(k1_compact_case(
                    f"{name} {'facet' if b is fb else 'cell'} {form} "
                    f"C={C} float64", b.scatter_rows, b.scatter_idx,
                    b.gather_idx, b.dofs.reshape(-1).long(), flat, rows,
                    k1, gen, flush))

    model = StreamerModel(StreamerConfig(), device="cuda")
    bs = BatchedSystem(model.system, SWEEP_B)
    cb, fb = bs.batches[0][0], bs.batches[1][0]
    check(cb.scatter_rows is None and fb.scatter_rows is not None,
          "the sweep's stacked tables")
    stacked(f"sweep B={SWEEP_B}", cb, fb, SWEEP_B * model.system.n_dofs)
    del model, bs
    m = StreamerModel(StreamerConfig(nx=280, ny=560, mg_levels=1),
                      device="cuda")
    d = m.distribute(["cuda"] * 8)
    cb, fb = d._batches[0][0], d._batches[1][0]
    stacked("dd_scale", cb, fb, d.n_parts * d.n_ext, d.n_ext)
    del m, d
    return cases


def _col_norms(u) -> list:
    """Per member, the per-column 2-norms of u [B, n_dofs, n_eq]."""
    return torch.linalg.vector_norm(u.double(), dim=1).tolist()


def _sweep_record(st) -> dict:
    return {"n_accepted": st.n_accepted.tolist(),
            "n_rejected": st.n_rejected.tolist(), "t": st.t.tolist(),
            "dt": st.dt.tolist(), "max_error": st.max_error.tolist(),
            "u_norms": _col_norms(st.u)}


def _sweep_gaps(rec, ref) -> dict:
    """The record's gaps to the JAX one: counts equal, and the largest
    relative gap over the members of t, dt, max_error and the column
    norms."""
    out = {k: rec[k] == ref[k] for k in ("n_accepted", "n_rejected")}
    for k in ("t", "dt", "max_error", "u_norms"):
        got, want = rec[k], ref[k]
        flat = lambda x: (x if not isinstance(x[0], list)  # noqa: E731
                          else [v for row in x for v in row])
        out[k] = max(_rel(flat(got), flat(want)))
    return out


def _sweep_held(name, gaps, tols: dict) -> None:
    log(f"sweep {name}: {gaps}")
    check(gaps["n_accepted"] and gaps["n_rejected"],
          f"sweep {name}: accepted/rejected counts differ from the JAX "
          f"sweep's")
    for k, tol in tols.items():
        check(gaps[k] <= tol, f"sweep {name}: {k} off the JAX sweep by "
                              f"{gaps[k]:.3e} > {tol:.0e}")


def _shared_scalars(residual, jac, delta, config, pb, residual_hi=None,
                    active=None):
    """The control: the single-system `newton_krylov` over the stacked
    members, every dot, norm and stopping test shared by them."""
    import numpy as np

    from fedm_tpu_torch.solvers.newton import NewtonInfo, newton_krylov

    d, info = newton_krylov(residual, jac, delta, config, pb, residual_hi)
    return d, NewtonInfo(*(np.full(delta.shape[0], x) for x in info))


def sweep(k1, card) -> dict:
    """Phase 9: the batched sweep of B = 8 members of the JAX package's
    default StreamerConfig, held to tools/port_reference_sweep.py."""
    import dataclasses

    import numpy as np

    import fedm_tpu_torch.model.system as tsys
    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.parallel import BatchedSweep
    from fedm_tpu_torch.solvers import newton

    ref = REF_SWEEP
    out = {"card": card}
    cfg = StreamerConfig()
    t = time.perf_counter()
    model = StreamerModel(cfg, device="cuda")
    states = [StreamerModel(dataclasses.replace(cfg, seed_amplitude=a),
                            device="cuda").initial_state()
              for a in SWEEP_AMPS]
    sw = BatchedSweep(model.system, monitor_idx=1, ttol=cfg.ttol,
                      dt_min=cfg.dt_min, dt_max=cfg.dt_max,
                      batch_sharding="cuda")
    st0 = sw.from_states(states)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    B, n_dofs, n_eq = st0.u.shape
    out.update(members=B, dofs=n_dofs, unknowns=B * n_dofs * n_eq)
    log(f"sweep: {B} members of {n_dofs} dofs ({n_dofs * n_eq} unknowns "
        f"each, {out['unknowns']} in the batch), built with their initial "
        f"states in {out['build_s']:.2f} s")
    check((B, n_dofs, n_eq) == (SWEEP_B, 13041, 3), "the sweep's size")
    out["initial_rel"] = max(_rel(
        [v for row in _col_norms(st0.u) for v in row],
        [v for row in ref["initial"] for v in row]))
    log(f"sweep initial states: largest rel. gap of the column norms to "
        f"JAX's {out['initial_rel']:.3e}")
    check(out["initial_rel"] <= SWEEP_INITIAL_RTOL,
          "the sweep's initial states differ from the JAX package's")

    # K1's launches per batched Krylov iteration (2 J v, 2 M), B = 1 and
    # 8; then SWEEP_PROFILED_ITERS iterations of the batched BiCGStab on
    # the first Newton system under the profiler: wall time per iteration
    # and the device's idle share (the summed kernel durations against
    # the wall time), at B = 1 and 8
    from torch.profiler import ProfilerActivity, profile

    from fedm_tpu_torch.solvers.linear import bicgstab_batched

    per_iter, profiled = {}, {}
    for nb in (1, B):
        bs = sw.batched(nb)
        p = StepParams(*(np.asarray(x[:nb]) for x in
                         (st0.t + st0.dt, st0.dt, st0.dt_old)))
        ops = bs.operators(st0.u[:nb], st0.u_old1[:nb], p)
        delta = torch.zeros((nb * n_dofs, n_eq), dtype=torch.float64,
                            device="cuda")
        J, M = ops.jacobian_action(delta), bs.block_precond_builder(ops)(
            delta)
        v = torch.ones_like(delta)
        torch.cuda.synchronize()
        k1.LAUNCHES.clear()
        for _ in range(2):
            v = M(J(v))
        torch.cuda.synchronize()
        per_iter[nb] = dict(k1.LAUNCHES)

        def op(x, J=J, M=M):
            return M(J(x.reshape(-1, n_eq))).reshape(x.shape)

        rhs = M(-ops.residual(delta)).reshape(nb, n_dofs, n_eq)
        bicgstab_batched(op, rhs, tol=1e-30, maxiter=2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            _, _, its = bicgstab_batched(op, rhs, tol=1e-30,
                                         maxiter=SWEEP_PROFILED_ITERS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.end - e.time_range.start for e in dev) / 1e6
        profiled[str(nb)] = {
            "iterations": int(its.max()), "wall_s": wall,
            "wall_ms_per_iteration": 1e3 * wall / max(int(its.max()), 1),
            "device_events": len(dev),
            "busy_s": busy if dev else "not measured",
            "idle_share": 1.0 - busy / wall if dev else "not measured"}
        del ops, J, M, rhs, v
    out["k1_launches_per_krylov_iteration"] = {
        str(nb): sum(c.values()) for nb, c in per_iter.items()}
    out["profiled_krylov"] = profiled
    log(f"K1 launches per batched Krylov iteration: B=1 {per_iter[1]}, "
        f"B={B} {per_iter[B]}; the batched Krylov loop profiled: "
        f"{profiled}")
    check(per_iter[1] == per_iter[B] and sum(per_iter[1].values()) > 0,
          "K1's launches per Krylov iteration grow with the batch")

    # the main run: counts set to 0 just before, read just after
    bs = sw.batched(B)
    first, counts = [], {}
    step = bs.step

    def recording(*a, **kw):
        res = step(*a, **kw)
        if not first:
            first.append(res)
        return res

    def counted(name, fn):
        def run(*a, **kw):
            res = fn(*a, **kw)
            counts[name] = counts.get(name, 0) + (
                1 if name == "newton_iteration_batched"
                else int(np.max(res[2])))
            return res

        return run

    patches = {name: counted(name, getattr(newton, name)) for name in
               ("newton_iteration_batched", "bicgstab_batched",
                "gmres_batched")}
    attempt_s, gaps = [], []
    k1.LAUNCHES.clear()
    torch.cuda.synchronize()
    with mock.patch.object(bs, "step", recording), \
            mock.patch.multiple(newton, **patches):
        st = st0
        for i in range(SWEEP_ATTEMPTS):
            t = time.perf_counter()
            st = sw.attempt(st, {})
            torch.cuda.synchronize()
            attempt_s.append(time.perf_counter() - t)
            gaps.append(_sweep_gaps(_sweep_record(st), ref["attempts"][i]))
        n0 = st.n_accepted + st.n_rejected
        t = time.perf_counter()
        st = sw.run_until(st, SWEEP_HORIZON, {})
        torch.cuda.synchronize()
        until_s = time.perf_counter() - t
    launches = k1_launches(k1)
    shapes = collections.Counter()
    for (_, table, C, dt), n in k1.LAUNCHES.items():
        shapes[f"{table} C={C} {dt}"] += n
    until = _sweep_record(st)
    until["attempts"] = int((st.n_accepted + st.n_rejected - n0).max())
    out.update(attempt_s=attempt_s, run_until_s=until_s,
               run_until_attempts=until["attempts"],
               iterations=dict(counts), launches=launches,
               launches_by_shape=dict(sorted(shapes.items())),
               attempt_gaps=gaps, t=until["t"], dt=until["dt"],
               n_accepted=until["n_accepted"],
               n_rejected=until["n_rejected"])
    log(f"sweep: {SWEEP_ATTEMPTS} attempts {attempt_s} s, run_until "
        f"{until_s:.2f} s over {until['attempts']} attempts (JAX "
        f"{ref['run_until']['attempts']}), iterations {counts}, K1 "
        f"{out['launches_by_shape']}")
    for i, g in enumerate(gaps):
        _sweep_held(f"attempt {i + 1}", g, SWEEP_ATTEMPT_RTOL)
    out["run_until_gaps"] = _sweep_gaps(until, ref["run_until"])
    _sweep_held("run_until", out["run_until_gaps"], SWEEP_UNTIL_RTOL)
    check(until["attempts"] == ref["run_until"]["attempts"],
          "run_until took another number of attempts than JAX's")
    check(bool(torch.isfinite(st.u).all()), "non-finite sweep state")
    check(shapes.get("dense C=3 f64", 0) > 0
          and shapes.get("compact C=3 f64", 0) > 0,
          f"the sweep never launched K1 at its stacked tables: {shapes}")

    # each member's first attempt against the single-system step from the
    # same state at the same parameters
    u_b, info_b = first[0]
    check(list(info_b.iters) == ref["first_newton"],
          f"first attempt's Newton iterations {list(info_b.iters)} differ "
          f"from JAX's {ref['first_newton']}")
    singles, single_s = [], []
    for b in range(B):
        p = StepParams(float(st0.t[b] + st0.dt[b]), float(st0.dt[b]),
                       float(st0.dt_old[b]))
        torch.cuda.synchronize()
        t = time.perf_counter()
        u_s, info_s = model.system.step(st0.u[b], st0.u[b], st0.u_old1[b],
                                        {}, p)
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t)
        scale = u_s.abs().amax(dim=0)
        gap = float(((u_b[b] - u_s).abs().amax(dim=0) / scale).max())
        singles.append({"newton_batched": int(info_b.iters[b]),
                        "newton_single": int(info_s.iters),
                        "converged": [bool(info_b.converged[b]),
                                      bool(info_s.converged)],
                        "state_gap": gap})
    out.update(first_vs_single=singles, single_step_s=single_s,
               batch_first_attempt_s=attempt_s[0],
               sequential_first_attempts_s=sum(single_s))
    log(f"sweep first attempt vs single steps: {singles}; the batch "
        f"{attempt_s[0]:.2f} s, {B} single steps {sum(single_s):.2f} s "
        f"({[round(x, 3) for x in single_s]})")
    for b, rec in enumerate(singles):
        check(rec["newton_batched"] == rec["newton_single"]
              and rec["converged"][0] == rec["converged"][1]
              and rec["state_gap"] <= SWEEP_SINGLE_RTOL,
              f"member {b}'s batched attempt differs from its single step: "
              f"{rec}")

    # the control: one Newton-BiCGStab over the stacked block-diagonal
    # system, its scalars and norms shared by the members
    st = st0
    with mock.patch.object(tsys, "newton_krylov_batched", _shared_scalars):
        for _ in range(SWEEP_ATTEMPTS):
            st = sw.attempt(st, {})
    control = _sweep_gaps(_sweep_record(st), ref["attempts"][-1])
    out["control_gaps"] = control
    log(f"sweep control (shared scalars), after {SWEEP_ATTEMPTS} attempts: "
        f"{control}")
    check(all(not control[k] <= tol for k, tol in SWEEP_ATTEMPT_RTOL.items()),
          "the shared-scalar control holds the sweep's tolerances: they "
          "cannot tell per-member Krylov scalars apart")
    return out


def dd_scale(card) -> dict:
    """Phase 10: `python -m fedm_tpu_torch.dd_scale` as a process, at its
    defaults (280 x 560, 472,923 unknowns, 8 parts stacked on the card, 2
    steps, then the same steps undistributed), held to
    bench_assets/dd_scale_r03.log."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fedm_tpu_torch.dd_scale", "--steps",
         str(len(DD_SCALE_REF["errors"]))],
        capture_output=True, text=True, cwd=ROOT,
        timeout=max(60, BUDGET_S - (time.perf_counter() - T0)))
    wall = time.perf_counter() - t
    check(proc.returncode == 0, f"dd_scale failed: {proc.stderr[-2000:]}")
    text = proc.stdout
    log("dd_scale: " + " | ".join(text.strip().splitlines()))
    m = re.search(r"mesh 280x560: (\d+) dofs, (\d+) unknowns", text)
    part = re.search(r"partition: (\d+) own \+ (\d+) ghost rows/device",
                     text)
    iters = [int(x) for x in re.findall(r"iters=(\d+)", text)]
    errs = [[float(x) for x in row.split(", ")] for row in re.findall(
        r"step errors: \[([0-9.e+, -]+)\]", text)]
    steps = re.findall(r"step \d: ([0-9.]+)s on 8 parts, ([0-9.]+)s "
                       r"undistributed", text)
    k1n = re.search(r"K1 launches: (\d+)", text)
    out = {"card": card, "process_s": wall,
           "dofs": int(m[1]) if m else None,
           "unknowns": int(m[2]) if m else None,
           "own": int(part[1]) if part else None,
           "ghost": int(part[2]) if part else None,
           "newton_iterations": iters, "step_errors": errs,
           "step_s": [float(a) for a, _ in steps],
           "undistributed_step_s": [float(b) for _, b in steps],
           "k1_launches": int(k1n[1]) if k1n else 0}
    log(f"dd_scale: {out}")
    check((out["dofs"], out["unknowns"], out["own"], out["ghost"])
          == DD_SCALE_REF["layout"], f"dd_scale's size or partition "
                                     f"differs from the JAX tool's")
    n = len(DD_SCALE_REF["errors"])
    check(iters == [DD_SCALE_REF["newton"]] * (2 * n),
          f"dd_scale Newton iterations {iters}, JAX {DD_SCALE_REF['newton']}")
    check(len(errs) == 2 and all(
        len(row) == n and all(abs(e - r) <= DD_SCALE_ERR_ATOL
                              for e, r in zip(row, DD_SCALE_REF["errors"]))
        for row in errs), f"dd_scale step errors {errs} off the JAX "
                          f"tool's {DD_SCALE_REF['errors']}")
    check(len(steps) == n, "dd_scale printed no step times")
    check(out["k1_launches"] > 0, "dd_scale never launched K1")
    return out


def streamer_example(card) -> dict:
    """Phase 9b: `python -m fedm_tpu_torch.examples.streamer --quick -T
    2e-11` as a process, its output tree and `relative error.log` held to
    the JAX example's (tools/port_reference_streamer_example.py)."""
    import tempfile

    import numpy as np

    ref = REF_STREAMER_EXAMPLE
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fedm_tpu_torch.examples.streamer",
             "--quick", "-T", "2e-11", "-o", tmp], capture_output=True,
            text=True, cwd=ROOT,
            timeout=max(60, BUDGET_S - (time.perf_counter() - T0)))
        wall = time.perf_counter() - t
        check(proc.returncode == 0,
              f"the streamer example failed: {proc.stderr[-2000:]}")
        tree = sorted(str(p.relative_to(tmp)) for p in Path(tmp).rglob("*"))
        rows = np.loadtxt(Path(tmp) / "relative error.log", ndmin=2)
    last = proc.stdout.strip().splitlines()[-1]
    out = {"card": card, "process_s": wall, "last_line": last,
           "errors": rows[:, 0].tolist()}
    log(f"streamer example on the card in {wall:.2f} s: {last}")
    check(tree == ref["tree"], f"the streamer example wrote {tree}")
    check(last == ref["last_line"], f"the streamer example printed {last}")
    want = np.asarray(ref["errors"])
    check(rows.shape == want.shape and np.array_equal(rows[:, 1:],
                                                      want[:, 1:]),
          "the streamer example's dt columns differ from JAX's")
    out["error_rel"] = held_to("streamer example relative error.log",
                               rows[:, 0].tolist(), want[:, 0].tolist(),
                               [STREAMER_EXAMPLE_RTOL] * len(want))
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
                      hi_residual=True, host_loop=True)
    cfg = StreamerConfig(dtype=torch.float32, newton=nc,
                         z_corridor=(0.0, 1.08e-2, 1e-5),
                         density_floor=1e13, r_corridor=(2e-3, 2e-5),
                         poisson_precond="mg-zline")
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
    # K1 at the time-of-flight tables (phase 7's paths), timed here while
    # the profiler's traces are whole
    tof_cases = tof_k1_cases(k1, flush)
    # K1 at the extended scheme's shapes (phase 8's paths): the stacked
    # domain-decomposition tables and the undistributed cell table
    ext_cases = extended_k1_cases(k1, flush)
    # K1 at this slice's shapes (phases 5, 9 and 10's paths)
    sweep_cases = sweep_k1_cases(k1, flush)
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
    window, wmodel, moved = fresh_window(k1, card)

    phase("4b rescue")
    rescue_out = rescue(k1, card, wmodel, moved)
    del wmodel, moved

    phase("5 glow")
    glow_out = glow(k1, card)

    phase("6 options")
    options_out = options(k1, card)

    # phase 8 runs before 7, whose 2D run takes the length the budget left
    # allows
    phase("8 extended")
    ext_out = extended(k1, card)

    phase("9 sweep")
    sweep_out = sweep(k1, card)

    phase("9b streamer example")
    example_out = streamer_example(card)

    phase("10 dd_scale")
    dd_out = dd_scale(card)

    phase("7 tof")
    tof_out = tof(k1, card)
    signal.alarm(0)
    option_launches = collections.Counter()
    for rec in options_out["advance"].values():
        option_launches.update(rec["launches"])

    main_case = compact[0]  # facet C=3 float32: the main path's usual launch
    kernels = [{
        "name": "ell_scatter", "route": "cuda",
        "source": "fedm_tpu_torch/csrc/ell_scatter.cu",
        "replaces": "fedm_tpu/ops/pallas_scatter.py:34",
        "launches": (sum(launches.values())
                     + sum(window["launches"].values())
                     + sum(rescue_out["launches"].values())
                     + sum(glow_out["launches"].values())
                     + sum(option_launches.values())
                     + sum(tof_out["1d_launches"].values())
                     + sum(tof_out["2d_launches"].values())
                     + sum(ext_out["launches"].values())
                     + sum(sweep_out["launches"].values())
                     + dd_out["k1_launches"]),
        "launches_by_path": {"restart": launches,
                             "fresh_window": window["launches"],
                             "rescue": rescue_out["launches"],
                             "glow": glow_out["launches"],
                             "options": dict(option_launches),
                             "tof_1d": tof_out["1d_launches"],
                             "tof_2d": tof_out["2d_launches"],
                             "extended": ext_out["launches"],
                             "sweep": sweep_out["launches"],
                             "dd_scale": dd_out["k1_launches"]},
        "sweep_launches_by_shape": sweep_out["launches_by_shape"],
        "extended_launches_by_shape":
            ext_out["distributed_step"]["launches_by_shape"],
        "glow_launches_by_shape": glow_out["launches_by_shape"],
        "max_abs_err": max(c["max_abs_err"] for c in
                           cases + compact + glow_cases + tof_cases
                           + ext_cases + sweep_cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
        "floor_ms": main_case["floor_ms"],
        "replaced_path_ms": main_case["replaced_path_ms"],
        # device times taken by CUDA events where the profiler dropped its
        # traces (each then ~4 us high, see devtime.event_ms); 0 in a
        # healthy run
        "event_timed": devtime.event_fallbacks,
        "cases": (cases + compact + glow_cases + tof_cases + ext_cases
                  + sweep_cases)}]
    print(json.dumps({
        "kernels": kernels,
        "main_path": {"unknowns": unknowns,
                      "advance_s": step_s,
                      "median_advance_s": statistics.median(step_s),
                      "accepted": accepted, "attempts": attempts,
                      "peak_bytes": peak, "residual_norms": norms,
                      "residual_rel_to_jax": rel},
        "fresh_window": window, "rescue": rescue_out, "glow": glow_out,
        "options": options_out,
        "tof": tof_out, "extended": ext_out, "sweep": sweep_out,
        "streamer_example": example_out, "dd_scale": dd_out}))
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
