"""Smoke test of the PyTorch/CUDA port on one GPU, and on several: builds
the hand-written kernels, holds each against its plain PyTorch version,
and drives the port's paths at full size: the Bagheri streamer restart
that `bench.py` times, the streamer from t = 0 on its moving window with
the direct rescue, the argon glow, the streamer's option paths, the
time-of-flight verification runs (1D P2 and 2D axisymmetric) with their
entry point, the extended reaction scheme under the DOF-partitioned
domain decomposition with its entry point, the batched parameter sweep
and its option paths, the streamer example, the post-processing entry
points and the domain decomposition at scale; where the
machine has two cards or more, the domain decomposition and the sweep on
distinct cards, one rank (process) each, and the structured streamer on
z-slabs, one rank per card.

    python3 chip_smoke.py                # every phase; one card needed
    python3 chip_smoke.py --only cards   # phases 0, 1, 11 and 12
    python3 chip_smoke.py --only slabs   # phases 0, 1 and 12 alone
    python3 chip_smoke.py --only window  # phases 0, 1, 4 and 4b alone

The full run drives its phases in two processes on the card: phases 4
and 4b run as `--only window` beside phases 5-10, and the processes that
phases 7, 8, 9a, 10 and 13 start (entry points as a user runs them) run
beside the phase that starts them or beside 9b. Their host work, most of
each path's time, then overlaps; the times each phase reports are taken
with the others running.

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
     residual against its plain version (exactly), then 4 adaptive
     advances with K1's launch
     counter reset just before and read just after; the third runs
     BiCGStab to its cap and then the GMRES fallback, which must run;
  5. the glow: the argon glow discharge at the `glow50` protocol of
     `python -m fedm_tpu_torch.glow_run` (crossed 64 x 64 mesh, 8,321
     dofs, 41,605 unknowns, the synthetic argon tree generated into a
     temporary directory) from t = 0: the initial state, its first float64
     residual, and at a probe state the per-advance coefficients and the
     float64 residual, each held to the JAX package's numbers
     (tools/port_reference_glow.py), each residual tolerance shown to
     refuse the residual evaluated in float32; K1 inside the probe
     residual against the plain scatter; then 4 adaptive advances, each
     of which must land, with K1's launch counter
     reset just before and read just after, which must show launches of
     K1's dense form (the unstructured cell scatter);
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
     step; the entry point with `--devices 8 --steps 1` as a process
     (through a one-rank group, `--cards 1`: no collective runs);
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
     and B = 8 (equal), then 3 lockstep attempts and `run_until` 7e-12
     with K1's launch counter reset just before and read just after, held
     per member to tools/port_reference_sweep.py's JAX numbers (counts,
     t, dt, max_error, the states' column norms); each member's first
     attempt against the single-system step from the same state (the
     same Newton iterations), with the batch's wall time beside the 8
     single steps'; the control (one Newton-BiCGStab over the stacked
     members, scalars shared) must fail the tolerances;
  9a. the streamer example: `python -m fedm_tpu_torch.examples.streamer
     --quick -T 2e-11` as a process, its output tree, last line and
     `relative error.log` held to the JAX example's
     (tools/port_reference_streamer_example.py);
  9b. the sweep's option paths: phase 9's B = 8 members under the
     transport z-lines (`tzline`: poisson_precond "mg-zline",
     transport_zline, float64) and under row equilibration in float32
     (`row_scaled_f32`), the configurations of
     tools/port_reference_options.py, from phase 9's initial states; for
     each, 2 lockstep attempts with K1's launch counter reset just before
     and read just after (the dense in-place form on the stacked cell
     table, the compact form on the facets), held per member to
     tools/port_reference_sweep.py --config's JAX numbers (the first
     attempt's verdicts and Newton iterations, counts, t, dt, max_error,
     the column norms; counts equal or inside the JAX package's own
     spread); each member's first attempt against the single-system step
     (the same verdict, Newton and Krylov iterations, the state within a
     stated rtol), the batch's wall time beside the 8 single steps'; the
     control (the first attempt with the option off: no z-line solves, or
     no row weights) must fail both tolerances;
  13. post-processing (its processes run beside phase 9b): seeded run
     directories (tools/series_checkpoints.py: a streamer trail at the
     bagheri14 window, 30,305 dofs, on two corridors, with a reused mesh,
     a skipped dof mismatch and a duplicate; a glow50 run, 64 x 64, 8,321
     dofs) through `python -m fedm_tpu_torch.export_series` (both models)
     and `python -m fedm_tpu_torch.glow_report` as processes on the card,
     every VTU's per-field norms, the streamer's printed lines and
     `fields.pvd`, and the report's summary held to the JAX tools'
     (tools/port_reference_series.py); the same states rounded to float32
     must fail those tolerances;
  10. dd_scale: `python -m fedm_tpu_torch.dd_scale` as a process at its
     defaults (280 x 560, 472,923 unknowns, 8 parts stacked on the card,
     2 steps, then the same steps undistributed; a one-rank group):
     the size and the partition (20,196 own + 562 ghost rows a part), the
     Newton iterations and the step errors held to
     bench_assets/dd_scale_r03.log, the step times recorded both ways;
  11. cards (with two cards or more; on one, stderr says
     `11 cards: not run, 1 device` and the results line has
     "cards": null): R = 4 ranks (2 on a two-card machine), one per card
     (`fedm_tpu_torch.parallel.ranks`, NCCL), in one launch: the extended
     scheme's 8 parts, 8/R a card: residual and node blocks against the
     stacked one-card values (bit for bit where the cells' gradient einsum
     rounds a row alike at a rank's and the stacked cell counts, which a
     probe of it at the model's shapes decides; where it does not, within
     phase 8's tolerance, the gap recorded: cuBLAS picks that batched
     GEMM's kernel by the batch count, the first of the element kernel's
     einsums that fedm_tpu_torch.parallel.rank_probe finds rounding by
     the rank's rows), one step with the one-card
     Newton count and BiCGStab's equal to it or inside JAX's spread, the
     state within 1e-6 of the undistributed step, both refusing the
     control without the cross-rank reverse exchange, K1 launched on
     every card and held to its plain version on card 1; the streamer's
     DD (8 parts) with the distributed elliptic preconditioner, one step
     against the undistributed one; the sweep's 8 members, 8/R a card, 3
     attempts: counts equal to one card's, t, dt and the states within
     1e-12, held to the JAX numbers; then `dd_scale --cards
     R` as a process beside the one-card run; every card's name and
     power limit.
  12. slabs: the structured streamer on z-slabs
     (`CoupledSystem.use_gspmd`, `fedm_tpu_torch.parallel.slabs`). On
     every run, right after phase 3: the main path's system on one
     z-slab over a one-rank group against itself on one card (residual,
     J v, node blocks, one V-cycle, one z-line solve, one preconditioner
     application), bit for bit. With two cards or more (else stderr says
     `phase 12 slabs: R>1 not run, 1 device`), R = min(count, 4) ranks,
     one per card, in one launch against the same work on card 0: the
     restart's operators bit for bit (where a probe of the cells' einsum,
     or for the preconditioner of `block_apply`'s, in the operator's type
     finds it rounding by the row count, within
     phase 8's tolerance in float64, 1e-3 and 1e-4 of the largest entry
     in float32, the gap recorded), a residual without the halo row from
     below refused; the restart's 1 + 3 advances and the fresh window's
     forced move and 2 advances held to tools/gspmd_identity.py's
     identity rule (counts equal, t within 1e-9, fields within rtol
     5e-4, atol 1e-6), Newton counts equal, Krylov within 25 % or, for
     the window's advances, the JAX package's own spread, per-advance wall times, K1's launches and
     the collectives per Krylov iteration per rank, 5 BiCGStab
     iterations profiled on each rank and on one card (ms, idle share);
     each one-card reference runs on one rank's card in the same launch;
     K1 on each electrode rank's card against its plain version;
     `bagheri_run --preset bagheri14-fullgap --devices R` as a process,
     2 steps, and with one rank more than the cards (it must fail).
     The Poisson-row solves put on the slabs last: the
     point-smoothed geometric multigrid (`--precond mg`,
     `SlabGeometricMG`) and the Chebyshev solve (`SlabChebyshev`). On
     every run, before the one-rank check: the main path's system with
     each, one application on a one-rank group bit for bit with one
     card, and on 4 ranks emulated as threads on the card
     (`slab_probe.poisson_row`) bit for bit; K1 at the multigrid's
     coarse level against its plain version. With two cards or more,
     after job 4 and under a budget of their own: job 1b, job 1's V and
     M with each solve against one card (V bit for bit, the controls
     refused), and job 5: `bagheri_run --preset bagheri14-fullgap
     --precond mg` through `fedm_tpu_torch.parallel.counted_run`, 2
     advances from t = 0 on R ranks and then on one card: counts, t and
     dt, the fields; the Newton and Krylov counts of each advance and
     K1's launches per rank recorded.
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
# The window and the glow take 4 advances each (the third of the window
# is the GMRES one), and the sweep profiles 5 Krylov iterations: the depth
# slower hosts ran before, now on every host, so that phases 9b and 13
# fit the budget (PERF.md, sec. 6)
N_WINDOW_ADVANCES = 4
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
N_GLOW_ADVANCES = 4
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
# tools/port_reference_sweep.py --horizon 7e-12  (BatchedSweep over B = 8
# members of the default StreamerConfig, graded 80 x 160, float64, "mg",
# seed amplitudes geomspace(1e18, 2e19, 8); per member the initial states'
# column norms,
# the first attempt's Newton iterations, and after each of 3 attempts and
# after run_until(7e-12): the counts, t, dt, max_error and the state's
# column norms)
SWEEP_B = 8
SWEEP_AMPS = tuple(float(a) for a in np.geomspace(1e18, 2e19, SWEEP_B))
SWEEP_ATTEMPTS = 3
SWEEP_HORIZON = 7e-12
SWEEP_PROFILED_ITERS = 5
REF_SWEEP = {"initial": [[3470.6365421583196, 3418.3339510248147,
    1457347.647546141], [3474.597419825185, 3418.3339510248147,
    1462778.6890561387], [3478.7126715510462, 3418.3339510248147,
    1471214.177333928], [3482.982836578452, 3418.3339510248147,
    1484394.6485969678], [3487.4084310308826, 3418.3339510248147,
    1505162.725875443], [3491.989947606089, 3418.3339510248147,
    1538256.4867449314], [3496.727854222533, 3418.3339510248147,
    1591734.0881322925], [3501.622594770474, 3418.3339510248147,
    1679492.8472147426]], "first_newton": [2, 2, 2, 2, 3, 4, 5, 2],
    "attempts": [{"n_accepted": [1, 1, 1, 1, 1, 0, 0, 0], "n_rejected": [0,
    0, 0, 0, 0, 1, 1, 1], "t": [5e-12, 5e-12, 5e-12, 5e-12, 5e-12, 0.0, 0.0,
    0.0], "dt": [5e-12, 5e-12, 5e-12, 5e-12, 5e-12, 2.358596890435744e-12,
    8.79836158028602e-13, 2.5e-12], "max_error": [[1.1284209247108497e-05,
    1.0, 1.0], [1.8698382577412942e-05, 1.0, 1.0], [4.121409710145997e-05,
    1.0, 1.0], [0.00011924570693360566, 1.0, 1.0], [0.0003619028166314206,
    1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
    "u_norms": [[3470.62071836914, 3418.3211229818135, 1457347.6470622402],
    [3474.581680576234, 3418.324690662721, 1462778.6883072914],
    [3478.6970447070794, 3418.334725896549, 1471214.1761804947],
    [3482.96740837496, 3418.3699479073084, 1484394.646900831],
    [3487.3935388679633, 3418.4953069502662, 1505162.724336324],
    [3491.989947606089, 3418.3339510248147, 1538256.4867449314],
    [3496.727854222533, 3418.3339510248147, 1591734.0881322925],
    [3501.622594770474, 3418.3339510248147, 1679492.8472147426]]},
    {"n_accepted": [2, 2, 2, 2, 2, 1, 1, 0], "n_rejected": [0, 0, 0, 0, 0,
    1, 1, 2], "t": [1e-11, 1e-11, 1e-11, 1e-11, 1e-11,
    2.358596890435744e-12, 8.79836158028602e-13, 0.0], "dt": [5e-12, 5e-12,
    5e-12, 5e-12, 5e-12, 5e-12, 1.894247447649398e-12,
    3.7561741769392476e-13], "max_error": [[1.1279008641139687e-05,
    1.1284209247108497e-05, 1.0], [1.8684676358422515e-05,
    1.8698382577412942e-05, 1.0], [4.118402060376995e-05,
    4.121409710145997e-05, 1.0], [0.00011915863800082705,
    0.00011924570693360566, 1.0], [0.00036154607757241217,
    0.0003619028166314206, 1.0], [0.0005005011274032052, 1.0, 1.0],
    [0.0005010323302952168, 1.0, 1.0], [1.0, 1.0, 1.0]],
    "u_norms": [[3470.6048945917896, 3418.308291868667, 1457347.646577729],
    [3474.565941337195, 3418.3154228295452, 1462778.6875570829],
    [3478.6814178717427, 3418.335484578445, 1471214.1750195648],
    [3482.951980197284, 3418.405923009409, 1484394.6451268154],
    [3487.378646970417, 3418.656819664002, 1505162.721968605],
    [3491.9838532686344, 3418.596297707631, 1538256.487437117],
    [3496.727028424328, 3418.6229871642245, 1591734.0899492034],
    [3501.622594770474, 3418.3339510248147, 1679492.8472147426]]},
    {"n_accepted": [3, 3, 3, 3, 3, 1, 1, 1], "n_rejected": [0, 0, 0, 0, 0,
    2, 2, 2], "t": [1.5e-11, 1.5e-11, 1.5e-11, 1.5e-11, 1.5e-11,
    2.358596890435744e-12, 8.79836158028602e-13, 3.7561741769392476e-13],
    "dt": [5e-12, 5e-12, 5e-12, 5e-12, 5e-12, 2.3590461242830997e-12,
    8.785886218166888e-13, 8.088308259693601e-13],
    "max_error": [[1.5031747653368336e-05, 1.1279008641139687e-05,
    1.1284209247108497e-05], [2.489464221946303e-05, 1.8684676358422515e-05,
    1.8698382577412942e-05], [5.487212158158693e-05, 4.118402060376995e-05,
    4.121409710145997e-05], [0.00015877853840812282, 0.00011915863800082705,
    0.00011924570693360566], [0.0004815871755214011, 0.00036154607757241217,
    0.0003619028166314206], [0.0005005011274032052, 1.0, 1.0],
    [0.0005010323302952168, 1.0, 1.0], [0.0005006904853867971, 1.0, 1.0]],
    "u_norms": [[3470.5837962392766, 3418.2911797127513,
    1457347.6459311622], [3474.544955699958, 3418.303056023337,
    1462778.6865547555], [3478.660582104584, 3418.3364759040924,
    1471214.173457329], [3482.9314093307744, 3418.4538757248215,
    1484394.642601033], [3487.358791480457, 3418.8724749865837,
    1505162.716950368], [3491.9838532686344, 3418.596297707631,
    1538256.487437117], [3496.727028424328, 3418.6229871642245,
    1591734.0899492034], [3501.624979565057, 3418.6487052615566,
    1679492.849753184]]}], "run_until": {"n_accepted": [3, 3, 3, 3, 3, 3, 8,
    21], "n_rejected": [0, 0, 0, 0, 0, 2, 2, 4], "t": [1.5e-11, 1.5e-11,
    1.5e-11, 1.5e-11, 1.5e-11, 7e-12, 7e-12, 7e-12], "dt": [5e-12, 5e-12,
    5e-12, 5e-12, 5e-12, 2.413567288095259e-12, 5.07330543175377e-13,
    2.8547087462796067e-13], "max_error": [[1.5031747653368336e-05,
    1.1279008641139687e-05, 1.1284209247108497e-05], [2.489464221946303e-05,
    1.8684676358422515e-05, 1.8698382577412942e-05], [5.487212158158693e-05,
    4.118402060376995e-05, 4.121409710145997e-05], [0.00015877853840812282,
    0.00011915863800082705, 0.00011924570693360566], [0.0004815871755214011,
    0.00036154607757241217, 0.0003619028166314206], [0.0006431096790453708,
    0.0005002648607837783, 0.0005005011274032052], [0.000324811984251861,
    0.0009955898771118283, 0.0009397047843201225], [0.0006272854262754146,
    0.0009257856123015754, 0.0009156742009042328]],
    "u_norms": [[3470.5837962392766, 3418.2911797127513,
    1457347.6459311622], [3474.544955699958, 3418.303056023337,
    1462778.6865547555], [3478.660582104584, 3418.3364759040924,
    1471214.173457329], [3482.9314093307744, 3418.4538757248215,
    1484394.642601033], [3487.358791480457, 3418.8724749865837,
    1505162.716950368], [3491.969919134035, 3419.198477846489,
    1538256.4811848034], [3496.718617861456, 3421.627594549213,
    1591733.9443256017], [3501.7022053451647, 3429.073496729581,
    1679488.65579235]], "attempts": 22}}
# Tolerances of phase 9, relative, the largest gap over the members. The
# step error is a ratio of small differences: the JAX package's own sweep
# from its initial states scaled by (1 + 1e-15 * seeded noise), two seeds
# (tools/port_reference_sweep.py --spread 2), lands after the 3 attempts
# within t 1.5e-14, dt 2.7e-14, max_error 4.4e-13, column norms 8.3e-16
# of its unperturbed run, and after run_until's 22 attempts (the 7e-12
# horizon) within dt 3.8e-13, max_error 7.0e-13, column norms 1.8e-15.
# The port on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 9.4e-16,
# 1.5e-15, 1.5e-14, 2.0e-14 after the attempts; 1.1e-9, 2.0e-9, 3.0e-12
# after run_until's 56 attempts to the earlier 2e-11 horizon. Each limit
# sits above the JAX package's own spread; the counts and run_until's t
# (the horizon) are exact. The control (the same batch through one
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
# Phase 9b: the sweep's option paths (tools/port_reference_options.py's
# configurations) at B = SWEEP_B, SWEEP_OPTION_ATTEMPTS lockstep attempts
# each. The JAX numbers, with the JAX package on the CPU:
#   JAX_PLATFORMS=cpu python tools/port_reference_sweep.py --config NAME
#       --attempts 2 --horizon 0 --spread 4 --spread-eps EPS
# (EPS 1e-15 for tzline, 4 seeds; 1e-7 for row_scaled_f32, 40 seeds), from
# phase 9's initial states: per member the first attempt's converged flags
# and Newton iterations, after each attempt the counts, t, dt, max_error
# and the column norms; "spread": the first attempt's Newton iterations
# and the final counts of the JAX sweep from those states scaled by
# (1 + EPS * seeded noise), each member's [least, most]
SWEEP_OPTION_ATTEMPTS = 2
SWEEP_OPTIONS = {"tzline": {"poisson_precond": "mg-zline",
                            "transport_zline": True},
                 "row_scaled_f32": {"row_scaled": True,
                                    "dtype": torch.float32}}
REF_SWEEP_OPTIONS = {"tzline": {"first": {"converged": [True, True, True,
    True, True, True, True, False], "newton_iterations": [2, 2, 2, 2, 3, 4,
    5, 2]}, "attempts": [{"n_accepted": [1, 1, 1, 1, 1, 0, 0, 0],
    "n_rejected": [0, 0, 0, 0, 0, 1, 1, 1], "t": [5e-12, 5e-12, 5e-12,
    5e-12, 5e-12, 0.0, 0.0, 0.0], "dt": [5e-12, 5e-12, 5e-12, 5e-12, 5e-12,
    2.358596890676842e-12, 8.798361580990274e-13, 2.5e-12],
    "max_error": [[1.1284209248395026e-05, 1.0, 1.0],
    [1.8698382557326115e-05, 1.0, 1.0], [4.121409718993717e-05, 1.0, 1.0],
    [0.00011924570717719511, 1.0, 1.0], [0.0003619028167243289, 1.0, 1.0],
    [1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
    "u_norms": [[3470.6207183691376, 3418.3211229818066,
    1457347.6470622544], [3474.5816805762297, 3418.324690662701,
    1462778.6883073295], [3478.6970447071094, 3418.334725896625,
    1471214.1761806437], [3482.9674083741716, 3418.3699479074517,
    1484394.646901356], [3487.393538867963, 3418.495306950315,
    1505162.7243363669], [3491.989947606089, 3418.3339510248147,
    1538256.4867449312], [3496.727854222533, 3418.3339510248147,
    1591734.0881322925], [3501.622594770474, 3418.3339510248147,
    1679492.8472147426]]}, {"n_accepted": [2, 2, 2, 2, 2, 1, 1, 0],
    "n_rejected": [0, 0, 0, 0, 0, 1, 1, 2], "t": [1e-11, 1e-11, 1e-11,
    1e-11, 1e-11, 2.358596890676842e-12, 8.798361580990274e-13, 0.0],
    "dt": [5e-12, 5e-12, 5e-12, 5e-12, 5e-12, 5e-12, 1.8942474476869418e-12,
    3.7561741771109053e-13], "max_error": [[1.1279008643084392e-05,
    1.1284209248395026e-05, 1.0], [1.8684676329504922e-05,
    1.8698382557326115e-05, 1.0], [4.1184020726269155e-05,
    4.121409718993717e-05, 1.0], [0.00011915863824487808,
    0.00011924570717719511, 1.0], [0.00036154607771337086,
    0.0003619028167243289, 1.0], [0.0005005011277049052, 1.0, 1.0],
    [0.0005010323304112709, 1.0, 1.0], [1.0, 1.0, 1.0]],
    "u_norms": [[3470.604894591788, 3418.3082918686505, 1457347.6465777468],
    [3474.5659413371927, 3418.3154228294943, 1462778.6875571162],
    [3478.681417871836, 3418.3354845786203, 1471214.1750197064],
    [3482.9519801976367, 3418.405923009752, 1484394.6451275663],
    [3487.3786469704164, 3418.6568196641406, 1505162.721968806],
    [3491.98385326863, 3418.5962977078707, 1538256.4874369833],
    [3496.727028424325, 3418.622987164271, 1591734.0899490123],
    [3501.622594770474, 3418.3339510248147, 1679492.8472147426]]}],
    "spread": {"eps": 1e-15, "seeds": 4, "first_newton": [[2, 2], [2, 2],
    [2, 2], [2, 2], [3, 3], [4, 4], [5, 5], [2, 2]], "n_accepted": [[2, 2],
    [2, 2], [2, 2], [2, 2], [2, 2], [1, 1], [1, 1], [0, 0]],
    "n_rejected": [[0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [1, 1], [1, 1],
    [2, 2]], "first_converged_alike": True}},
    "row_scaled_f32": {"first": {"converged": [False, False, False, False,
    True, True, True, False], "newton_iterations": [5, 9, 5, 11, 13, 11, 6,
    2]}, "attempts": [{"n_accepted": [0, 0, 0, 0, 1, 0, 0, 0],
    "n_rejected": [1, 1, 1, 1, 0, 1, 1, 1], "t": [0.0, 0.0, 0.0, 0.0, 5e-12,
    0.0, 0.0, 0.0], "dt": [2.5e-12, 2.5e-12, 2.5e-12, 2.5e-12, 5e-12,
    2.358592489417879e-12, 8.798458002009566e-13, 2.5e-12],
    "max_error": [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0,
    1.0, 1.0], [0.00036190379079555996, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0,
    1.0, 1.0], [1.0, 1.0, 1.0]], "u_norms": [[3470.6365421583196,
    3418.3339510248147, 1457347.647546141], [3474.597419825185,
    3418.3339510248147, 1462778.6890561387], [3478.7126715510462,
    3418.3339510248147, 1471214.177333928], [3482.982836578452,
    3418.3339510248147, 1484394.6485969678], [3487.3935388332243,
    3418.4953074332693, 1505162.747113822], [3491.989947606089,
    3418.3339510248147, 1538256.4867449314], [3496.727854222533,
    3418.3339510248147, 1591734.0881322925], [3501.622594770474,
    3418.3339510248147, 1679492.8472147426]]}, {"n_accepted": [0, 0, 0, 0,
    2, 1, 1, 0], "n_rejected": [2, 2, 2, 2, 0, 1, 1, 2], "t": [0.0, 0.0,
    0.0, 0.0, 1e-11, 2.358592489417879e-12, 8.798458002009566e-13, 0.0],
    "dt": [1.25e-12, 1.25e-12, 1.25e-12, 1.25e-12, 5e-12, 5e-12,
    1.894261545670949e-12, 3.756160133070353e-13], "max_error": [[1.0, 1.0,
    1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0],
    [0.000361546497736084, 0.00036190379079555996, 1.0],
    [0.0005005008625415137, 1.0, 1.0], [0.0005010391067594777, 1.0, 1.0],
    [1.0, 1.0, 1.0]], "u_norms": [[3470.6365421583196, 3418.3339510248147,
    1457347.647546141], [3474.597419825185, 3418.3339510248147,
    1462778.6890561387], [3478.7126715510462, 3418.3339510248147,
    1471214.177333928], [3482.982836578452, 3418.3339510248147,
    1484394.6485969678], [3487.3786469220136, 3418.656820397941,
    1505162.7358064344], [3491.983853269473, 3418.596297777769,
    1538256.5034191164], [3496.7270284158817, 3418.622991175428,
    1591734.170325964], [3501.622594770474, 3418.3339510248147,
    1679492.8472147426]]}], "spread": {"eps": 1e-07, "seeds": 40,
    "first_newton": [[5, 9], [4, 10], [4, 10], [8, 13], [9, 17], [11, 18],
    [5, 7], [2, 2]], "n_accepted": [[0, 0], [0, 0], [0, 0], [0, 0], [2, 2],
    [1, 1], [1, 1], [0, 0]], "n_rejected": [[2, 2], [2, 2], [2, 2], [2, 2],
    [0, 0], [1, 1], [1, 1], [2, 2]], "first_converged_alike": True}}}
# The attempts' tolerances, relative, the largest gap over the members,
# each a few times the JAX package's own spread (and above the port's gap
# on the H100, PERF.md sec. 6): tzline t 1.1e-12, dt 1.2e-10 (the
# controller's dt after a rejection amplifies rounding), max_error
# 4.9e-11, column norms 2.1e-14; row_scaled_f32 t 2.8e-5, dt 1.0e-4,
# max_error 7.8e-4, column norms 7.7e-8. The tzline control (no z-line
# solves) lay 1.0e-9 off in max_error and 2.6e-13 in the column norms on
# the H100; the float32 control (no weights) changes the verdicts.
SWEEP_OPTION_RTOL = {
    "tzline": {"t": 5e-12, "dt": 5e-10, "max_error": 2e-10,
               "u_norms": 1e-13},
    "row_scaled_f32": {"t": 1e-4, "dt": 5e-4, "max_error": 2e-3,
                       "u_norms": 2.5e-7}}
# a member's first attempt against its single step: its state, relative
# to each column's max (float64 equal up to 4.4e-12 on the H100; float32
# 4.8e-8, the batch rounding otherwise, see the Krylov tolerance below)
SWEEP_OPTION_SINGLE_RTOL = {"tzline": 1e-11, "row_scaled_f32": 1e-7}
# a member's Krylov iterations in its first attempt against its single
# step's, relative: equal in float64; in float32 the batch's cell GEMMs
# round by their batch count (PERF.md, sec. 7), which can move where a
# Newton step's BiCGStab stops by an iteration
SWEEP_OPTION_KRYLOV_RTOL = {"tzline": 0.0, "row_scaled_f32": 0.1}
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
# Phase 11: R ranks, one per card (4 where the machine has 4 cards, else
# 2), each holding EXT_PARTS / R parts of the domain decomposition and
# SWEEP_B / R members of the sweep; the time limit of its one launch
CARDS_LAUNCH_S = 420
CARDS_BUDGET_S = 600       # phase 11's own budget after the other phases
CARDS_STATE_RTOL = 1e-12   # the sweep's states on R cards vs one card
# and its t and dt: equal on the CPU (gloo); on the cards the members'
# kernels run on fewer rows, and the cells' gradient einsum (a batched
# GEMM) rounds by its batch count where cuBLAS picks another kernel for it
CARDS_TIME_RTOL = 1e-12
T0 = time.perf_counter()
_phase = "start"


class DeadlineExceeded(RuntimeError):
    pass


_budget = {"s": BUDGET_S}


def budget(seconds: int) -> None:
    """The alarm, `seconds` from now (the phases after it share them)."""
    _budget["s"] = seconds
    signal.alarm(seconds)


def _on_alarm(signum, frame):
    raise DeadlineExceeded(f"phase {_phase!r} overran the {_budget['s']} s "
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
                    launches["ell_scatter_add_"] / len(step_s),
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


def start_tof_quick() -> dict:
    """Phase 7's process: `python -m fedm_tpu_torch.examples.tof_1d
    --quick`, beside the phase's own runs."""
    return start_process(["fedm_tpu_torch.examples.tof_1d", "--quick", "-o",
                          "{tmp}/out"], "tof_1d_quick")


def tof(k1, card, quick: dict) -> dict:
    """Phase 7: the time-of-flight verification runs on the card, held to
    the JAX package's numbers (tools/port_reference_tof.py); `quick` the
    entry point's process (`start_tof_quick`)."""
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

    # the entry point, as a user runs it, on the card (its process started
    # with the phase, `start_tof_quick`)
    stdout = finish_process(quick, BUDGET_S)
    out["quick_s"] = quick["wall_s"]
    tmp = quick["tmp"] / "out"
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
        f"beside the phase, the kernel build loaded from the cache): "
        f"{stdout.strip().splitlines()[-1]}")
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


def start_extended_entry() -> dict:
    """Phase 8's process: `python -m fedm_tpu_torch.examples.
    extended_scheme --devices 8 --steps 1`, beside the phase's own work."""
    return start_process(["fedm_tpu_torch.examples.extended_scheme",
                          "--devices", EXT_PARTS, "--steps", 1],
                         "extended_scheme")


def extended(k1, card, entry: dict) -> dict:
    """Phase 8: the extended reaction scheme under the DOF-partitioned
    domain decomposition, held to tools/port_reference_extended.py's JAX
    numbers; `entry` the entry point's process (`start_extended_entry`)."""
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

    # (5) the entry point as a process (started with the phase,
    # `start_extended_entry`): one advance and one more
    re_ = ref["example"]
    lines = finish_process(entry, BUDGET_S).strip().splitlines()
    out["entry_point_s"] = entry["wall_s"]
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


def sweep(k1, card) -> tuple:
    """Phase 9: the batched sweep of B = 8 members of the JAX package's
    default StreamerConfig, held to tools/port_reference_sweep.py.
    Returns (the phase's results, the members' initial states)."""
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
            _, _, its = bicgstab_batched(
                op, rhs, tol=1e-30, maxiter=SWEEP_PROFILED_ITERS)
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
    return out, states


def _run_group(cmd, timeout: float) -> subprocess.CompletedProcess:
    """`cmd` in a session of its own, captured; on its time limit, or any
    exception here, the whole session is killed (the ranks it spawned
    too)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def start_dd_scale() -> dict:
    """Phase 10's process (`dd_scale(card, job=...)` waits for it)."""
    return start_process(["fedm_tpu_torch.dd_scale", "--steps",
                          len(DD_SCALE_REF["errors"]), "--cards", 1],
                         "dd_scale")


def dd_scale(card, n_cards: int = 1, timeout: float = None,
             job: dict = None) -> dict:
    """Phase 10: `python -m fedm_tpu_torch.dd_scale` as a process, at its
    defaults (280 x 560, 472,923 unknowns, 8 parts stacked on the card, 2
    steps, then the same steps undistributed), held to
    bench_assets/dd_scale_r03.log: `job` (`start_dd_scale`) waited for,
    or run here; with `n_cards` > 1 (phase 11) the 8 parts on that many
    cards, one rank each (`--cards`)."""
    if job is not None:
        text = finish_process(job, BUDGET_S)
        stderr, wall = (job["tmp"] / "stderr").read_text(), job["wall_s"]
    else:
        t = time.perf_counter()
        proc = _run_group(
            [sys.executable, "-m", "fedm_tpu_torch.dd_scale", "--steps",
             str(len(DD_SCALE_REF["errors"])), "--cards", str(n_cards)],
            max(60, BUDGET_S - (time.perf_counter() - T0))
            if timeout is None else timeout)
        wall = time.perf_counter() - t
        check(proc.returncode == 0,
              f"dd_scale failed: {proc.stderr[-2000:]}")
        text, stderr = proc.stdout, proc.stderr
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
    per_rank = collections.defaultdict(list)
    for rank, _, sec in re.findall(r"rank (\d+) step (\d+): ([0-9.]+) s",
                                   stderr):
        per_rank[int(rank)].append(float(sec))
    out = {"card": card, "cards": n_cards, "process_s": wall,
           "dofs": int(m[1]) if m else None,
           "unknowns": int(m[2]) if m else None,
           "own": int(part[1]) if part else None,
           "ghost": int(part[2]) if part else None,
           "newton_iterations": iters, "step_errors": errs,
           "step_s": [float(a) for a, _ in steps],
           "undistributed_step_s": [float(b) for _, b in steps],
           "rank_step_s": dict(sorted(per_rank.items())),
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
    check(sorted(per_rank) == list(range(n_cards))
          and all(len(v) == n for v in per_rank.values()),
          f"dd_scale's ranks printed no step times: {dict(per_rank)}")
    check(out["k1_launches"] > 0, "dd_scale never launched K1")
    return out


def start_process(argv: list, name: str) -> dict:
    """`python -m argv...` started on the card in a session of its own,
    its output in files; each "{tmp}" in `argv` is the job's temporary
    directory (`finish_process` waits for it, `stop_processes` ends it)."""
    import tempfile

    import threading

    tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
    argv = [str(a).replace("{tmp}", str(tmp)) for a in argv]
    with open(tmp / "stdout", "w") as so, open(tmp / "stderr", "w") as se:
        proc = subprocess.Popen([sys.executable, "-m"] + argv, stdout=so,
                                stderr=se, cwd=ROOT, start_new_session=True)
    job = {"name": name, "proc": proc, "tmp": tmp,
           "t0": time.perf_counter()}

    def wait():  # the process's own wall time, start to exit
        proc.wait()
        job["wall_s"] = time.perf_counter() - job["t0"]

    job["waiter"] = threading.Thread(target=wait, daemon=True)
    job["waiter"].start()
    return job


def finish_process(job: dict, timeout: float) -> str:
    """The job's stdout once it exits 0 (at most `timeout` s from its
    start; its stderr in the failure)."""
    job["waiter"].join(max(1.0, timeout - (time.perf_counter()
                                           - job["t0"])))
    rc = job["proc"].poll()
    check(rc == 0, f"{job['name']} failed, rc {rc}: "
                   f"{(job['tmp'] / 'stderr').read_text()[-2000:]}")
    return (job["tmp"] / "stdout").read_text()


def stop_processes(jobs: list) -> None:
    """Kill the jobs' sessions that still run; remove their files."""
    import shutil

    for job in jobs:
        if job["proc"] is not None and job["proc"].poll() is None:
            os.killpg(job["proc"].pid, signal.SIGKILL)
            job["proc"].wait()
        shutil.rmtree(job["tmp"], ignore_errors=True)


def start_streamer_example() -> dict:
    """Phase 9a's process: `python -m fedm_tpu_torch.examples.streamer
    --quick -T 2e-11`."""
    return start_process(["fedm_tpu_torch.examples.streamer", "--quick",
                          "-T", "2e-11", "-o", "{tmp}/out"],
                         "streamer_example")


def streamer_example(job: dict, card) -> dict:
    """Phase 9a: the streamer example's process (`start_streamer_example`)
    waited for, its output tree and `relative error.log` held to the JAX
    example's (tools/port_reference_streamer_example.py)."""
    ref = REF_STREAMER_EXAMPLE
    stdout = finish_process(job, SERIES_PROCESS_S)
    res = job["tmp"] / "out"
    tree = sorted(str(p.relative_to(res)) for p in res.rglob("*"))
    rows = np.loadtxt(res / "relative error.log", ndmin=2)
    last = stdout.strip().splitlines()[-1]
    out = {"card": card, "process_s": job["wall_s"], "last_line": last,
           "errors": rows[:, 0].tolist()}
    log(f"streamer example on the card in {job['wall_s']:.2f} s: {last}")
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


def _spread_holds(name: str, got: list, ref: list, spread) -> bool:
    """Per-member counts equal to the JAX run's, or each member's inside
    the JAX package's own spread [least, most]."""
    if got == ref:
        return True
    inside = spread is not None and all(
        lo <= g <= hi for g, (lo, hi) in zip(got, spread))
    log(f"{name}: {got} against JAX's {ref}: "
        f"{'inside' if inside else 'outside'} its spread {spread}")
    return inside


def _counting_b(counts: np.ndarray, fn, live):
    """`fn` (a batched Krylov solve), adding each member's iterations to
    `counts` while `live()` holds."""
    def run(*args, **kw):
        out = fn(*args, **kw)
        if live():
            np.add(counts, out[2], out=counts)
        return out

    return run


def sweep_option(name: str, k1, card, states) -> dict:
    """One option path of phase 9b (the docstring's phase list), its
    members from `states` (phase 9's initial states)."""
    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.parallel import BatchedSweep
    from fedm_tpu_torch.solvers import newton

    ref, tols = REF_SWEEP_OPTIONS[name], SWEEP_OPTION_RTOL[name]
    spread = ref.get("spread", {})
    out = {"card": card}
    cfg = StreamerConfig(**SWEEP_OPTIONS[name])
    t = time.perf_counter()
    model = StreamerModel(cfg, device="cuda")
    sw = BatchedSweep(model.system, monitor_idx=1, ttol=cfg.ttol,
                      dt_min=cfg.dt_min, dt_max=cfg.dt_max,
                      batch_sharding="cuda")
    st0 = sw.from_states(states)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    B, n_dofs, n_eq = st0.u.shape
    check((B, n_dofs, n_eq) == (SWEEP_B, 13041, 3),
          f"sweep {name}: the size")
    log(f"sweep {name}: {B} members, {B * n_dofs * n_eq} unknowns, built "
        f"in {out['build_s']:.2f} s")

    # the attempts: K1's counts set to 0 just before, read just after; the
    # first attempt's step kept, with each member's Krylov iterations
    bs = sw.batched(B)
    first, krylov = [], np.zeros(B, int)
    step = bs.step

    def recording(*a, **kw):
        res = step(*a, **kw)
        if not first:
            first.append(res)
        return res

    def during_first():
        return not first

    patches = {f: _counting_b(krylov, getattr(newton, f), during_first)
               for f in ("bicgstab_batched", "gmres_batched")}
    attempt_s, recs = [], []
    k1.LAUNCHES.clear()
    torch.cuda.synchronize()
    with mock.patch.object(bs, "step", recording), \
            mock.patch.multiple(newton, **patches):
        st = st0
        for _ in range(SWEEP_OPTION_ATTEMPTS):
            t = time.perf_counter()
            st = sw.attempt(st, {})
            torch.cuda.synchronize()
            attempt_s.append(time.perf_counter() - t)
            recs.append(_sweep_record(st))
    launches = k1_launches(k1)
    shapes = collections.Counter()
    for (_, table, C, dt), n in k1.LAUNCHES.items():
        shapes[f"{table} C={C} {dt}"] += n
    u_b, info_b = first[0]
    gaps = [_sweep_gaps(r, q) for r, q in zip(recs, ref["attempts"])]
    out.update(attempt_s=attempt_s, launches=launches,
               launches_by_shape=dict(sorted(shapes.items())),
               first_newton=list(map(int, info_b.iters)),
               first_krylov=krylov.tolist(),
               first_converged=list(map(bool, info_b.converged)),
               attempt_gaps=gaps, n_accepted=recs[-1]["n_accepted"],
               n_rejected=recs[-1]["n_rejected"], t=recs[-1]["t"],
               dt=recs[-1]["dt"])
    log(f"sweep {name}: {SWEEP_OPTION_ATTEMPTS} attempts {attempt_s} s; "
        f"first attempt Newton {out['first_newton']}, Krylov "
        f"{out['first_krylov']}, converged {out['first_converged']}; K1 "
        f"{out['launches_by_shape']}")
    check(out["first_converged"] == ref["first"]["converged"]
          and _spread_holds(f"sweep {name} first attempt's Newton",
                            out["first_newton"],
                            ref["first"]["newton_iterations"],
                            spread.get("first_newton")),
          f"sweep {name}: the first attempt's verdicts or Newton "
          f"iterations differ from JAX's")
    for i, g in enumerate(gaps):
        _sweep_held(f"{name} attempt {i + 1}", g, tols)
    check(bool(torch.isfinite(st.u).all()), f"sweep {name}: non-finite "
                                            f"state")
    dtype = "f32" if name.endswith("f32") else "f64"
    check(shapes.get(f"dense C=3 {dtype}", 0) > 0
          and shapes.get(f"compact C=3 {dtype}", 0) > 0,
          f"sweep {name} never launched K1 at its stacked tables: {shapes}")

    # each member's first attempt against the single-system step
    singles, single_s, u_single = [], [], []
    for b in range(B):
        p = StepParams(float(st0.t[b] + st0.dt[b]), float(st0.dt[b]),
                       float(st0.dt_old[b]))
        counts = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mock.patch.multiple(newton, bicgstab=counting(
                counts, "krylov", newton.bicgstab), gmres=counting(
                counts, "krylov", newton.gmres)):
            u_s, info_s = model.system.step(st0.u[b], st0.u[b],
                                            st0.u_old1[b], {}, p)
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t)
        u_single.append(u_s)
        scale = u_s.abs().amax(dim=0)
        singles.append({
            "newton": [int(info_b.iters[b]), int(info_s.iters)],
            "krylov": [int(krylov[b]), counts.get("krylov", 0)],
            "converged": [bool(info_b.converged[b]), bool(info_s.converged)],
            "state_gap": float(((u_b[b] - u_s).abs().amax(dim=0)
                                / scale).max())})
    out.update(first_vs_single=singles, single_step_s=single_s,
               sequential_first_attempts_s=sum(single_s))
    log(f"sweep {name} first attempt vs single steps: {singles}; the "
        f"batch {attempt_s[0]:.2f} s, {B} single steps "
        f"{sum(single_s):.2f} s")
    def alike(newton_b, krylov_b, gap, rec):
        """A batched member's first attempt held to its single step."""
        return (newton_b == rec["newton"][1]
                and abs(krylov_b - rec["krylov"][1])
                <= SWEEP_OPTION_KRYLOV_RTOL[name] * rec["krylov"][1]
                and gap <= SWEEP_OPTION_SINGLE_RTOL[name])

    for b, rec in enumerate(singles):
        check(alike(rec["newton"][0], rec["krylov"][0], rec["state_gap"],
                    rec) and rec["converged"][0] == rec["converged"][1],
              f"sweep {name}: member {b}'s batched attempt differs from its "
              f"single step: {rec}")

    # the control: the first attempt without the option (no z-line solves:
    # the node-block answer on the electron rows; no row weights)
    if name == "tzline":
        control = mock.patch.object(bs, "_tzline", None)
    else:
        control = mock.patch.object(model.system, "row_weights",
                                    lambda ops, d: torch.ones_like(d))
    first.clear()
    krylov[:] = 0
    with control, mock.patch.object(bs, "step", recording), \
            mock.patch.multiple(newton, **patches):
        rec = _sweep_record(sw.attempt(st0, {}))
    u_c, info_c = first[0]
    c_gaps = _sweep_gaps(rec, ref["attempts"][0])
    c_single = [float(((u_c[b] - u_single[b]).abs().amax(dim=0)
                       / u_single[b].abs().amax(dim=0)).max())
                for b in range(B)]
    out.update(control_gaps=c_gaps, control_single_gaps=c_single,
               control_newton=list(map(int, info_c.iters)),
               control_krylov=krylov.tolist())
    log(f"sweep {name} control: {c_gaps}; against the single steps "
        f"{c_single}, Newton {out['control_newton']}, Krylov "
        f"{out['control_krylov']}")
    check(not (c_gaps["n_accepted"] and c_gaps["n_rejected"] and all(
        c_gaps[k] <= tol for k, tol in tols.items())),
          f"sweep {name}: the control holds the JAX tolerances")
    check(not all(alike(nb, kb, g, rec) for nb, kb, g, rec in zip(
        out["control_newton"], out["control_krylov"], c_single, singles)),
          f"sweep {name}: the control holds the single-step tolerances")
    return out


def sweep_options(k1, card, states) -> dict:
    """Phase 9b: the batched sweep under each option of SWEEP_OPTIONS,
    from phase 9's initial states."""
    return {name: sweep_option(name, k1, card, states)
            for name in SWEEP_OPTIONS}


# -- phase 13: the post-processing entry points as processes on the card ----

# tools/port_reference_series.py (the JAX tools on the seeded run
# directories of tools/series_checkpoints.py): per VTU and field
# [2-norm, max |value|], the streamer export's lines and `fields.pvd`, the
# glow report's summary; "control": the same from the states rounded to
# float32
REF_SERIES = {"streamer": {"files": {"fields000000.vtu": {"electrons": [3.05033698932353e+21,
    9.997789742232293e+19], "ions": [3.134165868987967e+21,
    9.999478592092556e+19], "potential": [1797192.3503216454, 17999.6875],
    "E_magnitude": [63506609267.89941, 1708100480.0]},
    "fields000001.vtu": {"electrons": [3.0235593017671386e+21,
    9.997029759795174e+19], "ions": [3.0665257112600005e+21,
    9.991255124726094e+19], "potential": [1809549.147473579,
    17999.76171875], "E_magnitude": [63614080143.84686, 1600252160.0]},
    "fields000002.vtu": {"electrons": [3.039401774750726e+21,
    9.995797427162762e+19], "ions": [3.1151202937735506e+21,
    9.996461532185939e+19], "potential": [1817155.5632181955,
    17999.568359375], "E_magnitude": [61840165550.29927, 1053838528.0]}},
    "lines": ["  checkpoint_000000.npz: t=1.0000e-10 (10 steps, 30305 dofs)",
    "  checkpoint_000001.npz: t=2.0000e-10 (20 steps, 30305 dofs)",
    "  checkpoint_000002.npz: t=3.0000e-10 (30 steps, 30305 dofs)",
    "  skip checkpoint_000003.npz: 30208 dofs vs mesh 30305"],
    "pvd": ["<?xml version=\"1.0\"?>",
    "<VTKFile type=\"Collection\" version=\"0.1\" byte_order=\"LittleEndian\">",
    "  <Collection>",
    "    <DataSet timestep=\"1e-10\" part=\"0\" file=\"fields000000.vtu\" />",
    "    <DataSet timestep=\"2e-10\" part=\"0\" file=\"fields000001.vtu\" />",
    "    <DataSet timestep=\"3e-10\" part=\"0\" file=\"fields000002.vtu\" />",
    "  </Collection>", "</VTKFile>"]},
    "glow": {"files": {"Ar_plus_density/Ar_plus_density000000.vtu": {"Ar_plus_density": [2.4081979285845524e+18,
    9.988946028530642e+16]},
    "Ar_plus_density/Ar_plus_density000001.vtu": {"Ar_plus_density": [2.4299161388711695e+18,
    9.991557425598002e+16]},
    "Ar_star_density/Ar_star_density000000.vtu": {"Ar_star_density": [2.440578090884457e+18,
    9.997845028651886e+16]},
    "Ar_star_density/Ar_star_density000001.vtu": {"Ar_star_density": [2.4611842009674307e+18,
    9.999052742856877e+16]},
    "electrons/electrons000000.vtu": {"electrons": [2.443760552200376e+18,
    9.999776655510539e+16]},
    "electrons/electrons000001.vtu": {"electrons": [2.4095933830968745e+18,
    9.998488055865114e+16]},
    "energy_density/energy_density000000.vtu": {"energy_density": [2.443689492661194e+18,
    9.990902884975573e+16]},
    "energy_density/energy_density000001.vtu": {"energy_density": [2.442501808028553e+18,
    9.990354682116587e+16]},
    "mean_energy/mean_energy000000.vtu": {"mean_energy": [6685.173894064657,
    941.0955677149786]},
    "mean_energy/mean_energy000001.vtu": {"mean_energy": [6610.574689081418,
    906.5621080331453]},
    "potential/potential000000.vtu": {"potential": [13066.304497408266,
    249.9918561583077]},
    "potential/potential000001.vtu": {"potential": [13147.040633606912,
    249.9973005176535]}}}, "report": {"t_s": 2e-07, "steps": 200,
    "cathode": "z=gap (powered)", "total_fall_V": 35.10162126633767,
    "sheath_thickness_mm": 0.3125000000000003,
    "sheath_fraction_of_gap": 0.03125000000000003,
    "bulk_quasineutrality_median": 1.6486005749525119,
    "bulk_quasineutrality_max": 565.9919796048489,
    "ne_max_m3": 9.367879478784029e+16,
    "ne_bulk_mean_m3": 1.3041894622995484e+16,
    "eps_range_eV": [0.0013393629301641696, 448.3114429584031],
    "checks": {"cathode_fall_thin": True, "fall_majority_of_voltage": False,
    "bulk_quasineutral_trend": False, "fields_finite": True},
    "all_checks_pass": False},
    "control": {"streamer": {"files": {"fields000000.vtu": {"electrons": [3.0503371138939806e+21,
    9.997774788874155e+19], "ions": [3.1341658999277365e+21,
    9.99949178623209e+19], "potential": [1797192.3503216454, 17999.6875],
    "E_magnitude": [63506609275.82738, 1708100480.0]},
    "fields000001.vtu": {"electrons": [3.023559230260534e+21,
    9.99701216760913e+19], "ions": [3.0665257102587173e+21,
    9.991255124726094e+19], "potential": [1809549.147473579,
    17999.76171875], "E_magnitude": [63614080106.66362, 1600252160.0]},
    "fields000002.vtu": {"electrons": [3.0394017111960275e+21,
    9.995792149506949e+19], "ions": [3.1151203904308343e+21,
    9.996478244762681e+19], "potential": [1817155.5632181955,
    17999.568359375], "E_magnitude": [61840165576.78236, 1053838528.0]}},
    "lines": ["  checkpoint_000000.npz: t=1.0000e-10 (10 steps, 30305 dofs)",
    "  checkpoint_000001.npz: t=2.0000e-10 (20 steps, 30305 dofs)",
    "  checkpoint_000002.npz: t=3.0000e-10 (30 steps, 30305 dofs)",
    "  skip checkpoint_000003.npz: 30208 dofs vs mesh 30305"],
    "pvd": ["<?xml version=\"1.0\"?>",
    "<VTKFile type=\"Collection\" version=\"0.1\" byte_order=\"LittleEndian\">",
    "  <Collection>",
    "    <DataSet timestep=\"1e-10\" part=\"0\" file=\"fields000000.vtu\" />",
    "    <DataSet timestep=\"2e-10\" part=\"0\" file=\"fields000001.vtu\" />",
    "    <DataSet timestep=\"3e-10\" part=\"0\" file=\"fields000002.vtu\" />",
    "  </Collection>", "</VTKFile>"]},
    "glow": {"files": {"Ar_plus_density/Ar_plus_density000000.vtu": {"Ar_plus_density": [2.408197998723367e+18,
    9.988953687672982e+16]},
    "Ar_plus_density/Ar_plus_density000001.vtu": {"Ar_plus_density": [2.4299161906763587e+18,
    9.99154515250436e+16]},
    "Ar_star_density/Ar_star_density000000.vtu": {"Ar_star_density": [2.4405781487150413e+18,
    9.99783606091982e+16]},
    "Ar_star_density/Ar_star_density000001.vtu": {"Ar_star_density": [2.461184229834586e+18,
    9.999056574384814e+16]},
    "electrons/electrons000000.vtu": {"electrons": [2.443760457838073e+18,
    9.999781324750869e+16]},
    "electrons/electrons000001.vtu": {"electrons": [2.4095933964289014e+18,
    9.998484440147266e+16]},
    "energy_density/energy_density000000.vtu": {"energy_density": [2.443689508958815e+18,
    9.99089722327411e+16]},
    "energy_density/energy_density000001.vtu": {"energy_density": [2.4425018955255593e+18,
    9.99036366604529e+16]},
    "mean_energy/mean_energy000000.vtu": {"mean_energy": [6685.1744149961105,
    941.0967010482045]},
    "mean_energy/mean_energy000001.vtu": {"mean_energy": [6610.574688971826,
    906.560755976128]},
    "potential/potential000000.vtu": {"potential": [13066.304497550602,
    249.9918518066406]},
    "potential/potential000001.vtu": {"potential": [13147.040642008635,
    249.9972991943359]}}}, "report": {"t_s": 2e-07, "steps": 200,
    "cathode": "z=gap (powered)", "total_fall_V": 35.10162353515625,
    "sheath_thickness_mm": 0.3125000000000003,
    "sheath_fraction_of_gap": 0.03125000000000003,
    "bulk_quasineutrality_median": 1.64859852101837,
    "bulk_quasineutrality_max": 565.99318827943,
    "ne_max_m3": 9.36787352653262e+16,
    "ne_bulk_mean_m3": 1.3041890925758174e+16,
    "eps_range_eV": [0.0013393612751887677, 448.31128489530096],
    "checks": {"cathode_fall_thin": True, "fall_majority_of_voltage": False,
    "bulk_quasineutral_trend": False, "fields_finite": True},
    "all_checks_pass": False}}}
# The streamer's VTU fields are float32: an exp that rounds otherwise at
# one entry by a float64 ulp can round the float32 value otherwise, which
# moves a norm by up to ~1e-10 at 30,305 entries: 1e-9. The glow's fields
# (ascii float64) and the report: 1e-12. On the CPU the port's files equal
# the JAX tools' byte for byte; the control lies 1.5e-6 to 2.1e-6 off.
SERIES_RTOL = {"streamer": 1e-9, "glow": 1e-12, "report": 1e-12}
SERIES_PROCESS_S = 300


def _nested_gap(a, b) -> float:
    """The largest relative gap over the numbers of two nested records
    (inf where their keys, lengths, strings or flags differ)."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or sorted(a) != sorted(b):
            return float("inf")
        return max([_nested_gap(a[k], b[k]) for k in b] or [0.0])
    if isinstance(b, (list, tuple)):
        if not isinstance(a, (list, tuple)) or len(a) != len(b):
            return float("inf")
        return max([_nested_gap(x, y) for x, y in zip(a, b)] or [0.0])
    if isinstance(b, (bool, str)) or b is None:
        return 0.0 if a == b else float("inf")
    return abs(a - b) / max(abs(b), 1e-300)


def start_postprocess() -> list:
    """Phase 13's seeded run directories (tools/series_checkpoints.py) and
    its three processes started on the card: the streamer and glow
    exports and the glow report (the runs go with the jobs,
    `stop_processes`)."""
    import importlib.util
    import tempfile

    spec = importlib.util.spec_from_file_location(
        "series_checkpoints", ROOT / "tools" / "series_checkpoints.py")
    seeded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(seeded)
    runs = Path(tempfile.mkdtemp(prefix="chip_smoke_series_runs_"))
    seeded.streamer_trail(runs / "streamer", **seeded.STREAMER_WINDOW)
    seeded.glow_run(runs / "glow", seeded.GLOW50["n_dofs"])
    export = "fedm_tpu_torch.export_series"
    jobs = [start_process([export, "--run", runs / "streamer", "--model",
                           "streamer", "--out", "{tmp}/out"],
                          "export_series_streamer"),
            start_process([export, "--run", runs / "glow", "--model",
                           "glow", "--out", "{tmp}/out"],
                          "export_series_glow"),
            start_process(["fedm_tpu_torch.glow_report", runs / "glow",
                           "--out", "{tmp}/report.md"], "glow_report")]
    log("phase 13: 3 processes started")
    return jobs + [{"name": "seeded runs", "proc": None, "tmp": runs}]


def postprocess(jobs: list, card) -> dict:
    """Phase 13: the processes of `start_postprocess` waited for, their
    outputs held to the JAX tools' (REF_SERIES), the control refused."""
    from fedm_tpu_torch.io.vtu import read_vtu

    streamer, glow, report = jobs[:3]
    lines = finish_process(streamer, SERIES_PROCESS_S).splitlines()
    finish_process(glow, SERIES_PROCESS_S)
    finish_process(report, SERIES_PROCESS_S)
    out = {"card": card, "process_s": {j["name"]: j["wall_s"]
                                       for j in jobs[:3]}}

    def norms(d: Path, fields) -> dict:
        res = {}
        for p in sorted(d.rglob("*.vtu")):
            vals = {}
            for f in fields:
                try:
                    v = read_vtu(p, f)
                except KeyError:
                    continue
                vals[f] = [float(np.linalg.norm(v)), float(np.abs(v).max())]
            res[str(p.relative_to(d))] = vals
        return res

    md = (report["tmp"] / "report.md").read_text()
    m = re.search(r"```json\n(.*)\n```", md, re.S)
    check(m is not None, "phase 13: the report holds no JSON block")
    s_out, g_out = streamer["tmp"] / "out", glow["tmp"] / "out"
    got = {"streamer": {"files": norms(s_out, ("electrons", "ions",
                                               "potential", "E_magnitude")),
                        "lines": lines[:-1],
                        "pvd": (s_out / "fields.pvd").read_text()
                        .splitlines()},
           "glow": {"files": norms(g_out, (
               "energy_density", "Ar_star_density", "Ar_plus_density",
               "electrons", "potential", "mean_energy"))},
           "report": json.loads(m[1])}
    gaps = {k: _nested_gap(got[k], REF_SERIES[k]) for k in SERIES_RTOL}
    control = {k: _nested_gap(got[k], REF_SERIES["control"][k])
               for k in SERIES_RTOL}
    out.update(gaps=gaps, control_gaps=control,
               streamer_vtus=len(got["streamer"]["files"]),
               glow_vtus=len(got["glow"]["files"]),
               all_checks_pass=got["report"]["all_checks_pass"])
    log(f"phase 13: the processes in {out['process_s']} s; gaps to the "
        f"JAX tools {gaps}, to the float32 control {control}; streamer "
        f"lines {lines}")
    for k, tol in SERIES_RTOL.items():
        check(gaps[k] <= tol, f"phase 13 {k}: {gaps[k]:.3e} off the JAX "
                              f"tools' outputs > {tol:.0e}")
        check(not control[k] <= tol, f"phase 13 {k}: the float32 control "
                                     f"holds the tolerance ({control[k]:.3e})")
    return out


def _smi_lines() -> list:
    """`nvidia-smi --query-gpu=name,power.limit`: one line per card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines() or ["nvidia-smi gave no answer"]


def _rank_rows(results, key) -> torch.Tensor:
    """The ranks' rows of a distributed array, in rank order."""
    rows = [r[key] if not isinstance(key, tuple) else r[key[0]][key[1]]
            for r in results]
    return torch.cat(rows)


def _rank_vs_stacked(name, F, F1, B, B1, rows_probe) -> dict:
    """The ranks' residual and node blocks against the stacked one-card
    values: bit for bit where the cells' gradient einsum rounds a row alike
    at the ranks' and the stacked cell counts (`rows_probe`); where it
    does not, within phase 8's tolerance of distributed against
    undistributed, the gap recorded (fedm_tpu_torch.parallel.rank_probe
    traces the extended scheme's gap to that einsum first, and to the
    quadrature-value einsum after it)."""
    out = {"bitwise": [torch.equal(F, F1), torch.equal(B, B1)],
           "max_abs_diff": [float((F - F1).abs().max()),
                            float((B - B1).abs().max())],
           "max_abs": [float(F1.abs().max()), float(B1.abs().max())],
           "rows_round_alike": rows_probe["equal"],
           "residual": _close(f"{name}: residual", F, F1, EXT_OPS_RTOL,
                              atol_rel=EXT_OPS_ATOL_REL),
           "blocks": _close(f"{name}: node blocks", B, B1, EXT_OPS_RTOL,
                            atol_rel=EXT_OPS_ATOL_REL)}
    log(f"cards: {name}: {out}")
    check(all(out["bitwise"]) or not rows_probe["equal"],
          f"{name}: the residual or the node blocks differ from the stacked "
          f"one-card values, though the gradient einsum rounds a row alike "
          f"at both cell counts: {out}")
    check(out["residual"] <= 1.0 and out["blocks"] <= 1.0,
          f"{name}: the residual or the node blocks are off the stacked "
          f"one-card values: {out}")
    return out


def _grad_rows_probe(shape, R: int) -> dict:
    """Does the cells' gradient of a scalar field (`CellBatch.grad`'s
    einsum over the stacked batch's `grads` of `shape` [c, q, a, d]: a
    batched GEMM, c of [q, a] x [a, d], in float64) round a row the same
    over the stacked c cells as over a rank's c / R? cuBLAS picks its
    batched kernel by the batch count."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    g = torch.randn(tuple(shape), generator=gen, device="cuda",
                    dtype=torch.float64)
    n_cells = g.shape[0]
    u = torch.randn((n_cells, g.shape[2]), generator=gen, device="cuda",
                    dtype=torch.float64)
    n = n_cells // R
    full = torch.einsum("cqad,ca->cqd", g, u)
    part = torch.einsum("cqad,ca->cqd", g[:n], u[:n])
    return {"cells": [n_cells, n], "equal": bool(torch.equal(full[:n], part)),
            "max_abs_diff": float((full[:n] - part).abs().max())}


def cards(k1, count: int, one_card_dd_scale) -> dict:
    """Phase 11: the domain decomposition and the sweep on R cards, one
    rank each (NCCL), against the same work on one card in this process;
    then `python -m fedm_tpu_torch.dd_scale --cards R` as a process."""
    import dataclasses
    import shutil
    import tempfile

    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.parallel import BatchedSweep, rank_checks, ranks
    from fedm_tpu_torch.solvers import newton

    R = 4 if count >= 4 else 2
    smi = _smi_lines()
    out = {"ranks": R, "cards": smi, "grad_rows_probe": {}}
    for line in smi:
        log(f"cards: {line}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    # -- one card, this process (card 0): the stacked 8 parts, the
    # undistributed steps, the one-card sweep
    t = time.perf_counter()
    m, md, d = extended_models(Path(tmp))
    root = next(Path(tmp).iterdir())
    s, sd = m.initial_state(), md.initial_state()
    aux, auxd = m._update_aux(s.u), md._update_aux(sd.u)
    p = StepParams(*REF_EXTENDED["initial"]["params"])
    F1 = md.system.residual(sd.u, sd.u, sd.u_old1, p, aux=auxd).cpu()
    B1 = md.system.operators(sd.u, sd.u_old1, p, aux=auxd).jacobian_blocks(
        torch.zeros_like(sd.u)).cpu()
    F_und = m.system.residual(s.u, s.u, s.u_old1, p, aux=aux)
    u0_1 = sd.u.cpu()
    aux1 = {k: v.cpu() for k, v in auxd.items()
            if isinstance(v, torch.Tensor) and v.dim() >= 1
            and v.shape[0] == sd.u.shape[0]}
    counts = {}
    patches = {name: counting(counts, name, getattr(newton, name))
               for name in ("newton_iteration", "bicgstab", "gmres")}
    one = {}
    with mock.patch.multiple(newton, **patches):
        for key, model, st in (("undistributed", m, s),
                               ("8 parts", md, sd)):
            counts.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            u1, info = model.system.step(st.u, st.u, st.u_old1,
                                         model._update_aux(st.u), p)
            torch.cuda.synchronize()
            check(info.converged, f"the one-card extended {key} step did "
                                  f"not converge")
            one[key] = {"u": u1, "s": time.perf_counter() - t1,
                        **{k: counts.get(k, 0) for k in
                           ("newton_iteration", "bicgstab", "gmres")}}
    slot_of = d._slot_of_t.cpu()
    u_und = one["undistributed"]["u"].cpu()
    # K1 at the stacked compact cell table, the kernel's row of this run
    # where phase 2 did not run
    b = d._batches[0][0]
    out["grad_rows_probe"]["extended"] = _grad_rows_probe(b.grads.shape, R)
    gen = torch.Generator(device="cuda").manual_seed(13)
    flat = torch.randn((b.dofs.numel(), m.n_eq), generator=gen,
                       device="cuda", dtype=torch.float64)
    zero_pads(flat, b, d.n_ext)
    flush = l2_flush()
    out["k1_case"] = k1_compact_case(
        f"extended dd cell compact C={m.n_eq} float64", b.scatter_rows,
        b.scatter_idx, b.gather_idx, b.dofs.reshape(-1).long(), flat,
        d.n_parts * d.n_ext, k1, gen, flush)
    del flush
    del m, md, d, s, sd, aux, auxd
    sm = StreamerModel(StreamerConfig(), device="cuda")
    smd = StreamerModel(StreamerConfig(), device="cuda")
    sdd = smd.distribute(["cuda"] * EXT_PARTS)
    ss, ssd = sm.initial_state(), smd.initial_state()
    ps = StepParams(ss.t + ss.dt, ss.dt, ss.dt_old)
    SF1 = sdd.residual(ssd.u, ssd.u, ssd.u_old1, ps).cpu()
    SB1 = sdd.operators(ssd.u, ssd.u_old1, ps).jacobian_blocks(
        torch.zeros_like(ssd.u)).cpu()
    su_und, sinfo = sm.system.step(ss.u, ss.u, ss.u_old1, {}, ps)
    check(sinfo.converged, "the one-card streamer step did not converge")
    s_slot = sdd._slot_of_t.cpu()
    out["grad_rows_probe"]["streamer"] = _grad_rows_probe(
        sdd._batches[0][0].grads.shape, R)
    log(f"cards: the cells' gradient einsum over a rank's cells against "
        f"the same rows of the stacked ones: {out['grad_rows_probe']}")
    su_und = su_und.cpu()
    del sm, smd, sdd, ss, ssd
    cfg = StreamerConfig()
    model = StreamerModel(cfg, device="cuda")
    sw = BatchedSweep(model.system, monitor_idx=1, ttol=cfg.ttol,
                      dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    st = sw.from_states([StreamerModel(
        dataclasses.replace(cfg, seed_amplitude=a),
        device="cuda").initial_state() for a in SWEEP_AMPS])
    sweep_one = []
    for _ in range(SWEEP_ATTEMPTS):
        st = sw.attempt(st, {})
        sweep_one.append((_sweep_record(st), st.u.cpu()))
    del model, sw, st
    torch.cuda.synchronize()
    out["one_card_s"] = time.perf_counter() - t
    out["one_card_steps"] = {k: {kk: v for kk, v in rec.items()
                                 if kk != "u"} for k, rec in one.items()}
    log(f"cards: one-card references in {out['one_card_s']:.1f} s: "
        f"{out['one_card_steps']}")

    # -- R cards, one rank each, one launch
    ext_spec = dict(model="extended", tree=tmp, tree_name=root.name,
                    argv=[], n_parts=EXT_PARTS, step=True, control=True,
                    k1=True)
    str_spec = dict(model="streamer", cfg={}, n_parts=EXT_PARTS,
                    elliptic=2, step=True)
    sw_spec = dict(cfg={}, amps=list(SWEEP_AMPS), attempts=SWEEP_ATTEMPTS)
    t = time.perf_counter()
    res = ranks.launch(rank_checks.several, R, "cuda", (
        [("extended", "dd", ext_spec), ("streamer", "dd", str_spec),
         ("sweep", "sweep", sw_spec)],), timeout=CARDS_LAUNCH_S)
    out["launch_s"] = time.perf_counter() - t
    shutil.rmtree(tmp, ignore_errors=True)
    ext = [r["extended"] for r in res]
    devices = [e["card"]["device"] for e in ext]
    uuids = {e["card"].get("uuid") for e in ext}
    out["rank_cards"] = [e["card"] for e in ext]
    log(f"cards: {R} ranks in {out['launch_s']:.1f} s on {devices}")
    check(devices == [f"cuda:{r}" for r in range(R)] and len(uuids) == R,
          f"the ranks did not run on {R} distinct cards: {out['rank_cards']}")

    # the extended scheme: layout, residual and blocks bit for bit
    rp = REF_EXTENDED["partition"]
    for e in ext:
        check((e["n_own_max"], e["n_ghost_max"], e["shifts"])
              == (rp["n_own_max"], rp["n_ghost_max"], rp["shifts"]),
              f"rank {e['rank']}'s layout differs from the JAX package's")
    # against the stacked one-card values: bit for bit where the cells'
    # gradient einsum rounds a row alike at both cell counts; else within
    # phase 8's distributed-vs-undistributed tolerance, the gap recorded
    FR, BR = _rank_rows(ext, "F"), _rank_rows(ext, "B")
    out["residual_blocks"] = _rank_vs_stacked(
        f"extended, {R} cards vs 8 parts on one", FR, F1, BR, B1,
        out["grad_rows_probe"]["extended"])
    # where a gap comes from: the ranks' initial state and coefficients
    # (computed on the whole mesh on each card) against card 0's
    out["extended_inputs_bitwise"] = {
        "u0": torch.equal(_rank_rows(ext, "u0"), u0_1),
        **{k: torch.equal(torch.cat([e["aux"][k] for e in ext]), v)
           for k, v in aux1.items()}}
    log(f"cards: the extended inputs on {R} cards equal card 0's bit for "
        f"bit: {out['extended_inputs_bitwise']}")
    steps = [e["step"] for e in ext]
    keys = ("newton_iterations", "bicgstab_iterations", "gmres_iterations")
    got = {k: steps[0][k] for k in keys}
    check(all({k: st_[k] for k in keys} == got for st_ in steps)
          and all(st_["log"] == steps[0]["log"] for st_ in steps),
          "the ranks' Newton and Krylov logs differ")
    lo, hi = REF_EXTENDED["spread"]["bicgstab_iterations"]
    ref_one = one["8 parts"]
    check(all(st_["converged"] for st_ in steps)
          and got["newton_iterations"] == ref_one["newton_iteration"]
          and (got["bicgstab_iterations"] == ref_one["bicgstab"]
               or lo <= got["bicgstab_iterations"] <= hi)
          and got["gmres_iterations"] == 0,
          f"the extended step on {R} cards: {got}; one card "
          f"{ref_one}, JAX's spread {lo}-{hi}")
    u_r = _rank_rows(ext, ("step", "u"))[slot_of]
    out["extended"] = {
        "counts": got, "one_card_counts": {
            k: ref_one[k] for k in ("newton_iteration", "bicgstab",
                                    "gmres")},
        "step_s": [st_["s"] for st_ in steps],
        "one_card_step_s": ref_one["s"],
        "undistributed_step_s": one["undistributed"]["s"],
        "k1_launches": [sum(st_["launches"].values()) for st_ in steps],
        "k1_launches_by_shape": [st_["launches"] for st_ in steps],
        "state": _close(f"extended step, {R} cards vs undistributed", u_r,
                        u_und, EXT_STEP_RTOL, atol=EXT_STEP_ATOL),
        "control_residual": _close(
            f"extended residual on {R} cards without the cross-rank "
            f"reverse exchange (control)",
            _rank_rows(ext, "control_F")[slot_of], F_und.cpu(),
            EXT_OPS_RTOL, atol_rel=EXT_OPS_ATOL_REL),
        "control_step": _close(
            f"extended step on {R} cards without the cross-rank reverse "
            f"exchange (control)",
            _rank_rows(ext, ("control_step", "u"))[slot_of], u_und,
            EXT_STEP_RTOL, atol=EXT_STEP_ATOL),
        "k1_rank1": ext[1]["k1"]}
    oe = out["extended"]
    log(f"cards: extended {oe}")
    check(oe["state"] <= 1.0, f"the extended step on {R} cards is off the "
                              f"undistributed step")
    # (a control step that diverges to NaN is refused too)
    check(not (oe["control_residual"] <= 1.0 or oe["control_step"] <= 1.0),
          "a control without the cross-rank reverse exchange passes")
    check(all(n > 0 for n in oe["k1_launches"]),
          f"K1 was not launched on every card: {oe['k1_launches']}")
    kc = oe["k1_rank1"]
    check(kc["device"] == "cuda:1" and kc["launched"] == 1
          and kc["max_abs_err"] <= 1e-13 * kc["scale"],
          f"K1 on card 1 against its plain version: {kc}")

    # the streamer's DD with the distributed elliptic preconditioner
    sres = [r["streamer"] for r in res]
    out["streamer_residual_blocks"] = _rank_vs_stacked(
        f"streamer, {R} cards vs 8 parts on one", _rank_rows(sres, "F"),
        SF1, _rank_rows(sres, "B"), SB1, out["grad_rows_probe"]["streamer"])
    ssteps = [r["step"] for r in sres]
    check(all(st_["converged"] for st_ in ssteps)
          and all(st_["log"] == ssteps[0]["log"] for st_ in ssteps),
          "the streamer's step on the cards did not converge, or its "
          "ranks' logs differ")
    out["streamer"] = {
        "counts": {k: ssteps[0][k] for k in keys},
        "step_s": [st_["s"] for st_ in ssteps],
        "k1_launches": [sum(st_["launches"].values()) for st_ in ssteps],
        "state": _close(f"streamer step, distributed elliptic on {R} "
                        f"cards vs undistributed",
                        _rank_rows(sres, ("step", "u"))[s_slot], su_und,
                        EXT_STEP_RTOL, atol=EXT_STEP_ATOL)}
    log(f"cards: streamer {out['streamer']}")
    check(out["streamer"]["state"] <= 1.0, f"the streamer's step on {R} "
                                           f"cards is off the undistributed")

    # the sweep: 8 members over R cards
    swr = [r["sweep"] for r in res]
    check([list(range(8))[r_["members"]] for r_ in swr]
          == [list(range(k * 8 // R, (k + 1) * 8 // R)) for k in range(R)],
          "the sweep's members are not split evenly over the ranks")
    init = max(_rel([v for row in swr[0]["initial"]["u_norms"] for v in row],
                    [v for row in REF_SWEEP["initial"] for v in row]))
    check(init <= SWEEP_INITIAL_RTOL, "the sweep's initial states on the "
                                      "cards differ from JAX's")
    gaps = []
    for i, (rec1, u1) in enumerate(sweep_one):
        for r_ in swr:
            check(r_["records"][i] == swr[0]["records"][i],
                  "the ranks hold different SweepStates")
        got = swr[0]["records"][i]
        for k in ("n_accepted", "n_rejected"):
            check(got[k] == rec1[k], f"sweep attempt {i + 1} on {R} cards: "
                                     f"{k} {got[k]} differs from one card's "
                                     f"{rec1[k]}")
        # t and dt: equal, or nearly, where the members' kernels run on
        # fewer rows
        one_gap = {k: max(_rel(got[k], rec1[k])) for k in ("t", "dt")}
        log(f"cards: sweep attempt {i + 1}, t and dt against one card's: "
            f"{one_gap}")
        check(all(g <= CARDS_TIME_RTOL for g in one_gap.values()),
              f"sweep attempt {i + 1} on {R} cards: t or dt off one card's "
              f"by {one_gap}")
        gaps.append(_sweep_gaps(got, REF_SWEEP["attempts"][i]))
        _sweep_held(f"attempt {i + 1} on {R} cards", gaps[-1],
                    SWEEP_ATTEMPT_RTOL)
    u1 = sweep_one[-1][1]
    scale = u1.abs().amax(dim=1, keepdim=True)
    state_gap = float(((swr[0]["u"] - u1).abs() / scale).max())
    out["sweep"] = {"attempt_s": [r_["attempt_s"] for r_ in swr],
                    "k1_launches": [r_["launches"] for r_ in swr],
                    "initial_rel": init, "attempt_gaps": gaps,
                    "state_gap_to_one_card": state_gap}
    log(f"cards: sweep {out['sweep']}")
    check(state_gap <= CARDS_STATE_RTOL, f"the sweep's states on {R} cards "
                                         f"are {state_gap:.3e} off one "
                                         f"card's")
    del res, ext, sres, swr

    # dd_scale on R cards as a process, beside the one-card run
    if one_card_dd_scale is None:
        one_card_dd_scale = dd_scale(smi[0], timeout=CARDS_LAUNCH_S)
    out["dd_scale"] = dd_scale(smi[0], R, timeout=CARDS_LAUNCH_S)
    out["dd_scale_one_card"] = {
        k: one_card_dd_scale[k] for k in ("step_s", "undistributed_step_s")}
    log(f"cards: dd_scale warm step {out['dd_scale']['step_s'][-1]:.3f} s "
        f"on {R} cards, {one_card_dd_scale['step_s'][-1]:.3f} s on one "
        f"card (8 parts stacked), "
        f"{one_card_dd_scale['undistributed_step_s'][-1]:.3f} s "
        f"undistributed")
    return out


# -- phase 12: the structured streamer on z-slabs, one rank per card ---------

# the identity rule of tools/gspmd_identity.py:134-136
SLAB_FIELD_RTOL, SLAB_FIELD_ATOL, SLAB_T_RTOL = 5e-4, 1e-6, 1e-9
SLAB_RESTART_ADVANCES = 4     # 1 + 3, as phase 3
SLAB_WINDOW_ADVANCES = 2
SLAB_PROCESS_STEPS = 2
# A slab march's Newton and Krylov counts (BiCGStab and GMRES summed) per
# plan item must equal one card's in the same run or lie inside the port's
# own spread: one card's counts from the state perturbed before the first
# advance, those of this run (one card's own, and on every rank's card
# SLAB_SPREAD_EPS with the rank's seeds: perturbations at the float32
# type's own rounding, which the ranks' reordered sums make) widened by
# these: (newton, krylov) ranges per item from `python -m
# fedm_tpu_torch.parallel.slab_probe --spread restart|window --eps 1e-12
# 3e-12 1e-11 3e-11 1e-10 --seed 0 1` (one NVIDIA H100 80GB HBM3,
# 700.00 W: 8 runs each), the window's with the JAX package's own
# (ROADMAP.md section 3: the first advance after the move 71-739 Krylov,
# 2-3 Newton; the second 50-684)
SLAB_SPREAD = {
    "restart": {0: ((2, 2), (4, 5)), 1: ((2, 2), (4, 5)),
                2: ((2, 2), (4, 4)), 3: ((2, 2), (4, 5))},
    "window": {1: ((2, 3), (56, 1061)), 2: ((2, 3), (50, 843))}}
SLAB_SPREAD_EPS = (1e-8, 1e-7)
SLAB_LAUNCH_S = 420
SLAB_PROFILED_ITERS = 5       # BiCGStab iterations of M J under the profiler
SLAB_PROCESS_S = 300
SLAB_PROBE_S = 400
# phase 12's own budget (on four cards, after phase 11's CARDS_BUDGET_S)
SLABS_BUDGET_S = 480
# the operators of job 1 (`rank_checks.ops_record`)
SLAB_OPS = ("F", "F64", "Jv", "B", "V", "zline", "M")
# The Poisson-row solves phase 12 also puts on the slabs, by
# `rank_checks.slab_model`'s spec `poisson`: the point-smoothed geometric
# multigrid of poisson_precond="mg" and the Chebyshev solve; on one card
# each on a one-rank group and on SLAB_EMULATED_RANKS ranks emulated as
# threads (`slab_probe.poisson_row`), on R cards job 1's V and M of each
SLAB_PRECONDS = ("mg", "chebyshev")
SLAB_EMULATED_RANKS = 4
# Job 5: `python -m fedm_tpu_torch.bagheri_run --preset bagheri14-fullgap
# --precond mg` (546,795 unknowns), the first SLAB_FULLGAP_STEPS advances
# from t = 0 through `parallel.counted_run` (its Newton and Krylov counts),
# on R ranks and then on one card, one after the other, after job 4 and
# job 1b (job 1's V and M with each of SLAB_PRECONDS), the two under a
# budget of their own: counts equal, t and dt within SLAB_T_RTOL, the
# fields within the identity rule. The Newton and Krylov counts per
# advance are recorded, not held: no spread of them has been measured
# under this protocol (bagheri_run's own driver and fallback), and one
# card's counts under the march's protocol swung 40-191 per advance under
# 1e-12 perturbations (PERF.md section 6). SLAB_FULLGAP_BUDGET_S: jobs 1b
# and 5 took 190 s and 221 s in two runs on four NVIDIA H100 80GB HBM3,
# 700.00 W (PERF.md section 6; hosts differ up to ~1.5x), ~1.6x the
# larger; each process at most SLAB_FULLGAP_PROCESS_S (the 4-rank one
# took 58.4 s and 73.8 s)
SLAB_FULLGAP_STEPS = 2
SLAB_FULLGAP_PROCESS_S = 150
SLAB_FULLGAP_BUDGET_S = 360

def slab_specs() -> tuple:
    """Phase 12's model specs (`rank_checks.slab_model`): the restart
    (bench.py's configuration from the checkpoint) for the operators and
    for the identity protocol's 1 + 3 advances, and the fresh window
    (bagheri14 without its single-card direct rescue) from t = 0 through
    one forced move and 2 advances."""
    from fedm_tpu_torch import gspmd_identity

    restart = gspmd_identity.spec_for(CKPT, SLAB_RESTART_ADVANCES)
    ops = {k: restart[k] for k in ("cfg", "newton", "float32", "ckpt")}
    ops["profile_iters"] = SLAB_PROFILED_ITERS
    window = {"bagheri_argv": ["--preset", "bagheri14",
                               "--no-direct-rescue"],
              "corridor": REF_WINDOW["corridor"],
              "plan": [("move", REF_WINDOW["moved_to"])]
              + ["advance"] * SLAB_WINDOW_ADVANCES,
              "driver": {"fail_dt_cap": 0.7, "predictor": 1.0}}
    return ops, restart, window


def slabs_one_rank(model, state) -> dict:
    """Phase 12 on one card: the main path's system (phase 3's model, at
    its last state) against itself on z-slabs over a one-rank group: the
    residual, J v, node blocks, one V-cycle, one z-line solve and one
    preconditioner application, bit for bit."""
    from fedm_tpu_torch.parallel import rank_checks, ranks
    from fedm_tpu_torch.solvers.linesmoother import ZLineSmoother

    t = time.perf_counter()
    spec = {"seed": 5}
    sm = ZLineSmoother(model.system.masked_stiffness_op(2),
                       model._node_grid(model.space), model.space.n_dofs,
                       n_iter=2, dtype=model.batch.dtype, device="cuda")
    plain = rank_checks.ops_record(model, state, None, spec, sm)
    with ranks.one_rank("cuda") as group:
        slab = rank_checks.ops_record(model, state, group, spec, sm)
    out = {"bitwise": {k: torch.equal(slab[k], plain[k]) for k in SLAB_OPS},
           "rows": slab["rows"], "s": time.perf_counter() - t}
    log(f"slabs: one rank against one card: {out}")
    check(all(out["bitwise"].values()), f"the main path on one z-slab "
                                        f"differs from one card: {out}")
    return out


def slab_precond_systems(model) -> dict:
    """The main path's system (phase 3's model, on one card) with its
    Poisson row's solve replaced by each of SLAB_PRECONDS, {name: a
    shallow copy of the system} (the model keeps its own): "mg" the
    `GeometricMultigrid` a model with poisson_precond="mg" builds on this
    mesh, "chebyshev" the Chebyshev solve of `enable_elliptic_precond`."""
    import copy
    import dataclasses

    proxy = copy.copy(model)
    proxy.cfg = dataclasses.replace(model.cfg, poisson_precond="mg")
    out = {}
    for name in SLAB_PRECONDS:
        out[name] = copy.copy(model.system)
        if name == "mg":
            out[name].enable_elliptic_precond(2, mg=proxy._geometric_mg())
        else:
            out[name].enable_elliptic_precond(2)
    return out


def slab_poisson_rhs(system, seed: int) -> torch.Tensor:
    """The seeded right-hand side `rank_checks.ops_record` gives the
    Poisson-row solve (spec `seed`): the second draw of its generator."""
    n = system.n_dofs
    rng = np.random.default_rng(seed)
    rng.standard_normal((n, 3))
    return torch.as_tensor(rng.standard_normal(n),
                           device=system.bcs.mask.device).to(system.dtype)


def slabs_one_rank_precond(model, k1) -> dict:
    """Phase 12 on one card, the solves of SLAB_PRECONDS on the main
    path's restart system (`slab_precond_systems`): one application on a
    one-rank group against the system's own, bit for bit, and on
    SLAB_EMULATED_RANKS ranks emulated as threads against one card
    (`slab_probe.poisson_row`), each bit for bit; K1's launches counted
    from the hierarchy's setup, and K1 at its coarse level's table against
    its plain version."""
    from fedm_tpu_torch.ops.ell_scatter import ell_scatter, ell_scatter_ref
    from fedm_tpu_torch.parallel import ranks, slab_probe

    t = time.perf_counter()
    k1.LAUNCHES.clear()
    systems = slab_precond_systems(model)
    out = {"setup_s": time.perf_counter() - t,
           "k1_launches": k1_launches(k1)}
    lev = systems["mg"]._ell[1].__self__.levels[-1]
    gen = torch.Generator(device="cuda").manual_seed(17)
    flat = torch.randn((lev.batch.dofs.numel(), 1), generator=gen,
                       device="cuda")
    got, ref = ell_scatter(flat, lev._ell), ell_scatter_ref(flat, lev._ell)
    out["k1_coarse_level"] = {
        "rows": int(lev._ell.shape[0]), "max_val": int(lev._ell.shape[1]),
        "max_abs_err": float((got - ref).abs().max()),
        "scale": float(ref.abs().max())}
    check(out["k1_coarse_level"]["max_abs_err"]
          <= 1e-5 * out["k1_coarse_level"]["scale"],
          f"K1 at the multigrid's coarse level: {out['k1_coarse_level']}")
    for name, system in systems.items():
        r = slab_poisson_rhs(system, 5)
        plain = system._ell[1](r)
        with ranks.one_rank("cuda") as g:
            one = slab_probe._slab_solve(g, system, r)
        emu = slab_probe.poisson_row(system, r, SLAB_EMULATED_RANKS)
        out[name] = {"one_rank_bitwise": torch.equal(one, plain),
                     "emulated": emu}
        check(out[name]["one_rank_bitwise"],
              f"slabs: {name} on one z-slab differs from one card")
        check(emu["bitwise"], f"slabs: {name} on {SLAB_EMULATED_RANKS} "
                              f"emulated ranks differs from one card: {emu}")
    out["s"] = time.perf_counter() - t
    log(f"slabs: mg and the Chebyshev solve, one rank and emulated: {out}")
    return out


def _slab_rows(res, key) -> torch.Tensor:
    return torch.cat([r[key] for r in res])


def start_slab_probe() -> dict:
    """`python -m fedm_tpu_torch.parallel.slab_probe --case restart` on
    card 0, its tensors saved: job 1's ranks emulated as threads on one
    card (each at its own counts, no value crossing a card), and where
    their operators leave one card's, the op that does it."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_slabs_"))
    with open(tmp / "stdout", "w") as so, open(tmp / "stderr", "w") as se:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fedm_tpu_torch.parallel.slab_probe",
             "--case", "restart", "--device", "cuda:0", "--save",
             str(tmp / "probe.pt")], stdout=so, stderr=se, cwd=ROOT,
            start_new_session=True)
    return {"proc": proc, "tmp": tmp, "t0": time.perf_counter()}


def slab_probe_result(job: dict) -> dict:
    """`start_slab_probe`'s report and tensors (it must exit 0)."""
    proc = job["proc"]
    try:
        try:
            proc.wait(timeout=max(1.0, SLAB_PROBE_S
                                  - (time.perf_counter() - job["t0"])))
        except subprocess.TimeoutExpired:
            pass
        check(proc.poll() == 0, f"the slab probe failed (rc {proc.poll()}): "
                                f"{(job['tmp'] / 'stderr').read_text()[-2000:]}")
        return torch.load(job["tmp"] / "probe.pt", weights_only=False)
    finally:
        stop_slab_process(job)


def _slab_ops_vs_one(res, plain, emu, fail) -> dict:
    """Job 1: the ranks' rows of every operator against one card's, and
    against the same ranks emulated on one card (`emu`, the slab probe's).
    The ranks equal their emulation bit for bit (the cards move values
    only); they equal one card bit for bit, or the probe shows their
    difference to be count rounding alone (`emu["exempt"]`: the first op
    off is a batched GEMM at equal inputs, or M's `block_apply`) and they
    hold per column (`slab_probe.judge`). Controls that must fail that
    hold: the residual without the halo row from below, the same in its
    Poisson row alone, every operator's one-card result rounded to
    bfloat16, and for the float64 defect the float32 residual (computed in
    the lower precision). Failures go to `fail(ok, msg)`."""
    from fedm_tpu_torch.parallel.slab_probe import anchor_of, judge

    got = {k: _slab_rows(res, k) for k in SLAB_OPS}
    emu_got = {k: _slab_rows(emu["_ranks"], k) for k in SLAB_OPS}
    out = {"rows": [r["rows"] for r in res],
           "bitwise": {k: torch.equal(got[k], plain[k]) for k in SLAB_OPS},
           "emulated_bitwise": {k: torch.equal(got[k], emu_got[k])
                                for k in SLAB_OPS},
           "one_card_cards_bitwise": {k: torch.equal(plain[k],
                                                     emu["_one"][k])
                                      for k in SLAB_OPS},
           "exempt": emu["exempt"],
           "first_differing_ops": {key: [[b["ops"].get("op") for b in r]
                                         for r in v]
                                   for key, v in emu["kernels"].items()},
           "M_parts": emu["M_parts"], "held": {}}

    def held(k, x):
        return judge(x, plain[k], anchor_of(k, plain))

    for k in SLAB_OPS:
        out["held"][k] = held(k, got[k])
    control = _slab_rows(res, "control_F")
    poisson = got["F"].clone()
    poisson[:, 2] = control[:, 2]
    out["controls"] = {
        "dropped_row": held("F", control),
        "dropped_row_poisson_only": held("F", poisson),
        "float32_as_float64": held("F64", plain["F"].double()),
        "bfloat16": {k: held(k, plain[k].to(torch.bfloat16))
                     for k in SLAB_OPS}}
    log(f"slabs: operators {out}")
    fail(all(out["emulated_bitwise"].values())
         and all(out["one_card_cards_bitwise"].values()),
         f"slabs: the ranks' operators differ from the same ranks emulated "
         f"on one card, or one card's from another's: {out}")
    for k in SLAB_OPS:
        fail(out["bitwise"][k] or (out["exempt"][k] and out["held"][k]["ok"]),
             f"slabs: {k} on {len(res)} ranks differs from one card's: "
             f"{out}")
    c = out["controls"]
    fail(not any(v["ok"] for v in (c["dropped_row"],
                                   c["dropped_row_poisson_only"],
                                   c["float32_as_float64"]))
         and not any(v["ok"] for v in c["bfloat16"].values()),
         f"slabs: a control passes: {c}")
    return out


def slab_precond_specs(ops_spec: dict) -> dict:
    """Job 1's spec with each of SLAB_PRECONDS as the Poisson-row solve
    (`rank_checks.slab_model`'s `poisson`), unprofiled, recording V and M
    alone (`ops_record`'s `ops`)."""
    base = {k: v for k, v in ops_spec.items() if k != "profile_iters"}
    return {name: {**base, "poisson": name, "ops": ("V", "M")}
            for name in SLAB_PRECONDS}


def _slab_precond_vs_one(name, res, plain, emu, fail) -> dict:
    """Job 1 with the Poisson-row solve `name`: the ranks' V (one
    application) and M against one card's (`plain`, on another card). V
    bit for bit; M bit for bit, or where job 1's probe (`emu`) shows its
    difference to be count rounding (`slab_probe.exemptions`: its Poisson
    row bit for bit, the cell kernel or `block_apply` off at equal
    inputs), held per column (`judge`). The control (`ops_record`'s
    `control_V`: the V-cycle whose point smoother drops the halo row from
    below, the Chebyshev solve with lmax scaled by 1 + 1e-6) must differ
    from one card's V. Failures go to `fail(ok, msg)`."""
    from fedm_tpu_torch.parallel.slab_probe import exemptions, judge

    got = {k: _slab_rows(res, k) for k in ("V", "M")}
    m_row_equal = torch.equal(got["M"][:, 2], plain["M"][:, 2])
    out = {"bitwise": {k: torch.equal(got[k], plain[k]) for k in got},
           "M_poisson_row_equal": m_row_equal,
           "M_exempt": exemptions({"F": emu["exempt"]["F"]},
                                  emu["ops"]["B"]["bitwise"],
                                  emu["M_parts"]["by_rank"],
                                  m_row_equal)["M"],
           "M_held": judge(got["M"], plain["M"]),
           "control_bitwise": torch.equal(_slab_rows(res, "control_V"),
                                          plain["V"])}
    log(f"slabs: {name} on {len(res)} ranks: {out}")
    fail(out["bitwise"]["V"],
         f"slabs: {name}: V on {len(res)} ranks differs from one card's: "
         f"{out}")
    fail(out["bitwise"]["M"] or (out["M_exempt"] and out["M_held"]["ok"]),
         f"slabs: {name}: M on {len(res)} ranks differs from one card's: "
         f"{out}")
    fail(not out["control_bitwise"],
         f"slabs: {name}: the control equals one card's V: {out}")
    return out


def run_fullgap(n_devices: int, timeout: float) -> dict:
    """`python -m fedm_tpu_torch.parallel.counted_run COUNTS
    --preset bagheri14-fullgap --precond mg --devices N --max-steps
    SLAB_FULLGAP_STEPS` as a process in a session of its own, waited for
    (at most `timeout` s): rc, wall, rank 0's report, the counts of each
    advance by rank, the checkpoint's state."""
    import shutil
    import tempfile

    from fedm_tpu_torch.io import load_checkpoint

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fullgap_"))
    cmd = [sys.executable, "-m", "fedm_tpu_torch.parallel.counted_run",
           str(tmp / "counts.jsonl"), "--preset", "bagheri14-fullgap",
           "--precond", "mg", "--devices", str(n_devices), "--max-steps",
           str(SLAB_FULLGAP_STEPS), "--report-every", "1", "--out",
           str(tmp / "out")]
    t = time.perf_counter()
    job = {"proc": None, "tmp": tmp}
    try:
        with open(tmp / "stdout", "w") as so, \
                open(tmp / "stderr", "w") as se:
            job["proc"] = subprocess.Popen(cmd, stdout=so, stderr=se,
                                           cwd=ROOT, start_new_session=True)
        try:
            job["proc"].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        wall = time.perf_counter() - t
        text = (tmp / "stdout").read_text()
        rc = job["proc"].poll()
        check(rc == 0, f"counted bagheri_run --devices {n_devices} "
                       f"--precond mg failed (rc {rc}, {wall:.1f} s): "
                       f"{(tmp / 'stderr').read_text()[-2000:]}")
        rows = [json.loads(line) for line in
                (tmp / "counts.jsonl").read_text().splitlines()]
        st = load_checkpoint(tmp / "out" / "checkpoint.npz", device="cpu")
        return {"devices": n_devices, "rc": rc, "process_s": wall,
                "report": [line for line in text.splitlines()
                           if line.startswith(("device:", "t=",
                                               "STOPPED"))],
                "reports": len(re.findall(r"^t=", text, re.M)),
                "stopped": "STOPPED" in text,
                "rows": [r for r in rows if r["rank"] == 0],
                "k1_launches": [sum(r["k1_launches"] for r in rows
                                    if r["rank"] == q)
                                for q in range(n_devices)],
                "n_accepted": st.n_accepted, "t": st.t, "dt": st.dt,
                "u": st.u}
    finally:
        if job["proc"] is not None and job["proc"].poll() is None:
            os.killpg(job["proc"].pid, signal.SIGKILL)
            job["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)


def slab_fullgap(R: int) -> dict:
    """Job 5 (after job 4, alone on the cards): the full-gap protocol
    under --precond mg on R ranks, then on one card (`run_fullgap`), held
    as SLAB_FULLGAP_STEPS says."""
    many = run_fullgap(R, SLAB_FULLGAP_PROCESS_S)
    one = run_fullgap(1, SLAB_FULLGAP_PROCESS_S)
    rR, r1 = many.pop("rows"), one.pop("rows")
    uR, u1 = many.pop("u").double(), one.pop("u").double()
    keys = ("n_accepted", "n_rejected")
    out = {"ranks": many, "one_card": one, "counts": rR,
           "one_card_counts": r1,
           "newton_krylov": [((a["newton"], a["krylov"]),
                              (b["newton"], b["krylov"]))
                             for a, b in zip(rR, r1)],
           "t_rel": max([abs(a["t"] - b["t"]) / b["t"]
                         for a, b in zip(rR, r1)] + [0.0]),
           "dt_rel": max([abs(a["dt"] - b["dt"]) / b["dt"]
                          for a, b in zip(rR, r1)] + [0.0]),
           "max_rel_field_dev": float(((uR - u1).abs()
                                       / (u1.abs() + 1e-12)).max()),
           "fields_ok": bool(torch.allclose(uR, u1, rtol=SLAB_FIELD_RTOL,
                                            atol=SLAB_FIELD_ATOL)),
           "finite": bool(torch.isfinite(uR).all())}
    log(f"slabs: the full gap under mg on {R} ranks and on one card: {out}")
    failures = [msg for ok, msg in (
        (len(rR) == len(r1) == SLAB_FULLGAP_STEPS
         and all(a[k] == b[k] for a, b in zip(rR, r1) for k in keys),
         f"counts {[[a[k] for k in keys] for a in rR]} against one card's "
         f"{[[b[k] for k in keys] for b in r1]}"),
        (out["t_rel"] <= SLAB_T_RTOL and out["dt_rel"] <= SLAB_T_RTOL,
         f"t or dt off one card's: {out['t_rel']}, {out['dt_rel']}"),
        (out["fields_ok"] and out["finite"],
         f"the fields leave one card's: {out['max_rel_field_dev']}"),
        (all(m["stopped"] and m["reports"] >= SLAB_FULLGAP_STEPS
             and m["n_accepted"] == SLAB_FULLGAP_STEPS
             for m in (many, one)), "the runs' reports")) if not ok]
    check(not failures, f"slabs: the full gap under mg: {failures}")
    return out


def _krylov(row) -> int:
    return row["bicgstab_iterations"] + row["gmres_iterations"]


def _slab_march_vs_one(name, one, many, fail, spread, live) -> dict:
    """Jobs 2-3: the ranks' march against one card's: accepted and
    rejected counts equal, t within SLAB_T_RTOL, the fields within the
    identity rule, and per plan item the Newton and Krylov counts equal to
    one card's or inside the port's spread: `spread` {item: ((lo, hi) of
    Newton, of Krylov)} (SLAB_SPREAD) widened to one card's own and to
    `live`, this run's perturbed one-card marches (`krylov_spread`'s).
    Failures go to `fail(ok, msg)`."""
    r1, rR = one["rows"], many[0]["rows"]
    keys = ("n_accepted", "n_rejected", "newton_iterations",
            "bicgstab_iterations", "gmres_iterations")
    u1, uR = one["u"].double(), many[0]["u"].double()
    ok_fields = bool(torch.allclose(uR, u1, rtol=SLAB_FIELD_RTOL,
                                    atol=SLAB_FIELD_ATOL))
    pairs = [((a["newton_iterations"], _krylov(a)),
              (b["newton_iterations"], _krylov(b))) for a, b in zip(rR, r1)]
    iters = sum(a[1] for a, _ in pairs)
    coll = collections.Counter()
    for row in rR:
        coll.update(row["collectives"])
    ranges = {}
    for i, (_, b) in enumerate(pairs):
        seen = [b] + [(run["newton"][i], run["krylov"][i]) for run in live]
        lo_hi = spread.get(i, ((b[0], b[0]), (b[1], b[1])))
        ranges[i] = tuple((min([lo_hi[q][0]] + [x[q] for x in seen]),
                           max([lo_hi[q][1]] + [x[q] for x in seen]))
                          for q in (0, 1))
    out = {"counts": [{k: row[k] for k in keys} for row in rR],
           "one_card_counts": [{k: row[k] for k in keys} for row in r1],
           "newton_krylov": pairs, "spread": ranges,
           "live_spread": [{"eps": run["eps"], "seed": run["seed"],
                            "newton": run["newton"], "krylov": run["krylov"]}
                           for run in live],
           "t": [row["t"] for row in rR],
           "t_rel": max(abs(a["t"] - b["t"]) / b["t"] for a, b in zip(rR, r1)
                        if b["t"] > 0),
           "max_rel_field_dev": float(((uR - u1).abs()
                                       / (u1.abs() + 1e-12)).max()),
           "fields_ok": ok_fields,
           "rank_s": [[row["s"] for row in m["rows"]] for m in many],
           "one_card_s": [row["s"] for row in r1],
           "k1_launches": [sum(row["k1_launches"] for row in m["rows"])
                           for m in many],
           "one_card_k1_launches": sum(row["k1_launches"] for row in r1),
           "collectives": dict(coll),
           "collectives_per_krylov_iteration": {
               k: v / max(iters, 1) for k, v in coll.items()},
           "finite": bool(torch.isfinite(uR).all())}
    log(f"slabs: {name}: {out}")
    keys = ("n_accepted", "n_rejected")
    for a, b in zip(rR, r1):
        fail(all(a[k] == b[k] for k in keys),
             f"slabs: {name}: counts {[a[k] for k in keys]} differ from "
             f"one card's {[b[k] for k in keys]}")
    fail(all(a[q] == b[q] or ranges[i][q][0] <= a[q] <= ranges[i][q][1]
             for i, (a, b) in enumerate(pairs) for q in (0, 1)),
         f"slabs: {name}: Newton and Krylov counts {pairs} (ranks, one "
         f"card) outside the port's spread {ranges}")
    fail(all(abs(a["t"] - b["t"]) <= SLAB_T_RTOL * abs(b["t"])
             for a, b in zip(rR, r1)), f"slabs: {name}: t off one card's")
    fail(ok_fields and out["finite"], f"slabs: {name}: the fields leave "
                                      f"one card's: {out}")
    return out


def _same_rows(a: list, b: list) -> list:
    """Per plan item, whether two marches' records agree but for the wall
    time and the collectives."""
    skip = ("s", "collectives")
    return [{k: v for k, v in x.items() if k not in skip}
            == {k: v for k, v in y.items() if k not in skip}
            for x, y in zip(a, b)]


def start_slab_process(R: int) -> dict:
    """Job 4 started: `python -m fedm_tpu_torch.bagheri_run --preset
    bagheri14-fullgap --devices R` as a process in a session of its own,
    SLAB_PROCESS_STEPS steps on the full-gap mesh, its output in files
    (it runs beside the launch of jobs 1-3, on the same cards)."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_slabs_"))
    cmd = [sys.executable, "-m", "fedm_tpu_torch.bagheri_run", "--preset",
           "bagheri14-fullgap", "--devices", str(R), "--max-steps",
           str(SLAB_PROCESS_STEPS), "--report-every", "1", "--out",
           str(tmp / "out")]
    with open(tmp / "stdout", "w") as so, open(tmp / "stderr", "w") as se:
        proc = subprocess.Popen(cmd, stdout=so, stderr=se, cwd=ROOT,
                                start_new_session=True)
    return {"proc": proc, "tmp": tmp, "t0": time.perf_counter()}


def stop_slab_process(job: dict) -> None:
    """Kill job 4's session (its ranks too) if it still runs."""
    import shutil

    proc = job["proc"]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    shutil.rmtree(job["tmp"], ignore_errors=True)


def slab_process(job: dict, R: int, fail) -> dict:
    """Job 4 waited for (`start_slab_process`, at most SLAB_PROCESS_S from
    its start): rc 0, rank 0's report, a finite state; then one rank more
    than the cards, which must be refused."""
    import shutil
    import tempfile

    from fedm_tpu_torch.io import load_checkpoint

    proc, tmp = job["proc"], job["tmp"]
    try:
        try:
            proc.wait(timeout=max(1.0, SLAB_PROCESS_S
                                  - (time.perf_counter() - job["t0"])))
        except subprocess.TimeoutExpired:
            pass
        wall = time.perf_counter() - job["t0"]
        text = (tmp / "stdout").read_text()
        err = (tmp / "stderr").read_text()
        check(proc.poll() == 0, f"bagheri_run --devices {R} failed "
                                f"(rc {proc.poll()}, {wall:.1f} s): "
                                f"{err[-2000:]}")
        log("slabs: bagheri_run: " + " | ".join(text.strip().splitlines()))
        st = load_checkpoint(tmp / "out" / "checkpoint.npz", device="cpu")
        mesh = re.search(r"mesh: (\d+) dofs \((\d+) unknowns\)", text)
        out = {"process_s": wall, "rc": proc.returncode,
               "unknowns": int(mesh[2]) if mesh else None,
               "reports": len(re.findall(r"^t=", text, re.M)),
               "n_accepted": st.n_accepted, "t": st.t,
               "finite": bool(torch.isfinite(st.u).all())}
    finally:
        stop_slab_process(job)
    log(f"slabs: bagheri_run --devices {R}: {out}")
    fail(out["finite"] and out["n_accepted"] == SLAB_PROCESS_STEPS
         and out["reports"] >= SLAB_PROCESS_STEPS and "STOPPED" in text,
         f"bagheri_run --devices {R}: {out}")
    # more ranks than cards: refused before any rank starts
    n = torch.cuda.device_count() + 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slabs_")
    try:
        over = _run_group(
            [sys.executable, "-m", "fedm_tpu_torch.bagheri_run", "--preset",
             "bagheri14-fullgap", "--devices", str(n), "--out", tmp], 120)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["more_ranks_than_cards"] = {"devices": n, "rc": over.returncode}
    log(f"slabs: bagheri_run --devices {n}: rc {over.returncode}")
    fail(over.returncode != 0 and "CUDA devices, one each" in over.stderr,
         f"bagheri_run --devices {n} on {n - 1} cards did not raise: "
         f"{over.stderr[-1000:]}")
    return out


def slabs(k1, count: int) -> dict:
    """Phase 12 on R = min(count, 4) cards: the structured streamer on
    z-slabs, one rank per card (NCCL), against one card (each reference
    run on one rank's card alone, in the same launch, after the slab
    jobs): the restart's operators bit for bit or, where the slab probe
    shows count rounding alone, held per column (job 1), the restart's
    1 + 3 advances (job 2) and the fresh window's move and 2 advances
    (job 3) by the identity rule with the counts in the port's spread,
    `bagheri_run --devices R` as a process (job 4, beside the launch);
    K1 on each electrode rank's card against its plain version; the
    window on one slab of a one-rank group bit for bit with one card;
    then, alone on the cards, job 1b (`slab_preconds`) and job 5
    (`slab_fullgap`)."""
    from fedm_tpu_torch.parallel import rank_checks, ranks

    R = min(count, 4)
    ops_spec, restart_spec, window_spec = slab_specs()
    # the one-card references run in the same launch, after the slab
    # jobs, each on one rank's card alone (no group), in parallel; so does
    # the window on one slab of a one-rank group (rank 0), which must
    # march as one card does, bit for bit
    refs = [("plain_ops", "slab_ops", ops_spec),
            ("plain_restart", "slab_march", restart_spec),
            ("plain_window", "slab_march", window_spec),
            ("one_rank_window", "slab_march_one_rank", window_spec)]
    # then every rank marches the restart on its card from the state
    # perturbed at float32's rounding, its own seeds: this run's spread
    jobs = ([("ops", "slab_ops", ops_spec),
             ("restart", "slab_march", restart_spec),
             ("window", "slab_march", window_spec)]
            + [(key, "on_one_rank", {"rank": (i + 1) % R, "worker": name,
                                     "spec": spec})
               for i, (key, name, spec) in enumerate(refs)]
            + [("restart_spread", "krylov_spread",
                {**restart_spec, "before": 0,
                 "perturbations": [(e, 0) for e in SLAB_SPREAD_EPS]})])
    # job 4 and the slab probe run beside the launch, on the same cards
    job4, probe = start_slab_process(R), start_slab_probe()
    t = time.perf_counter()
    try:
        res = ranks.launch(rank_checks.several, R, "cuda", (jobs,),
                           timeout=SLAB_LAUNCH_S)
        emu = slab_probe_result(probe)
    except BaseException:
        stop_slab_process(job4)
        stop_slab_process(probe)
        raise
    out = {"ranks": R, "launch_s": time.perf_counter() - t}
    one = {key: next(r[key] for r in res if r[key] is not None)
           for key, _, _ in refs}
    plain = one["plain_ops"]
    out["reference_cards"] = [one[key]["card"]["device"]
                              for key, _, _ in refs]
    out["probe"] = {k: v for k, v in emu.items() if not k.startswith("_")}
    log(f"slabs: the ranks emulated on one card (slab probe, "
        f"{emu['s']:.1f} s): {out['probe']}")
    # every job is compared and logged; the phase fails at its end on the
    # first failures, all of them reported
    failures = []

    def fail(ok, msg):
        if not ok:
            log(f"slabs: FAILED CHECK: {msg}")
            failures.append(msg)

    devices = [r["ops"]["card"]["device"] for r in res]
    fail(devices == [f"cuda:{q}" for q in range(R)]
         and len({r["ops"]["card"].get("uuid") for r in res}) == R,
         f"the slab ranks did not run on {R} distinct cards: {devices}")
    out["krylov"] = {"one_card": plain["krylov"],
                     "ranks": [r["ops"]["krylov"] for r in res]}
    log(f"slabs: {SLAB_PROFILED_ITERS} BiCGStab iterations of M J, one card "
        f"and each rank: {out['krylov']}")
    out["ops"] = _slab_ops_vs_one([r["ops"] for r in res], plain, emu,
                                  fail)
    k1s = [r["ops"].get("k1") for r in res]
    out["k1_ranks"] = k1s
    log(f"slabs: K1 on the ranks' facet tables: {k1s}")
    fail(any(k is not None for k in k1s)
         and all(k is None or (k["launched"] == 1
                               and k["device"] == f"cuda:{q}"
                               and k["max_abs_err"] <= 1e-5 * k["scale"])
                 for q, k in enumerate(k1s)),
         f"K1 on the electrode ranks' cards against its plain version: "
         f"{k1s}")
    out["restart"] = _slab_march_vs_one(
        f"restart, {SLAB_RESTART_ADVANCES} advances on {R} ranks",
        one["plain_restart"], [r["restart"] for r in res], fail,
        SLAB_SPREAD["restart"],
        [run for r in res for run in r["restart_spread"]])
    out["window"] = _slab_march_vs_one(
        f"window, move and {SLAB_WINDOW_ADVANCES} advances on {R} ranks",
        one["plain_window"], [r["window"] for r in res], fail,
        SLAB_SPREAD["window"], [])
    w1, wp = one["one_rank_window"], one["plain_window"]
    out["one_rank_window"] = {
        "card": w1["card"]["device"],
        "u_equal": torch.equal(w1["u"], wp["u"]),
        "rows_equal": _same_rows(w1["rows"], wp["rows"]),
        "s": [row["s"] for row in w1["rows"]]}
    log(f"slabs: the window on one slab of a one-rank group against one "
        f"card: {out['one_rank_window']}")
    fail(out["one_rank_window"]["u_equal"]
         and all(out["one_rank_window"]["rows_equal"]),
         f"slabs: the window on one slab of a one-rank group differs from "
         f"one card's: {out['one_rank_window']}")
    del res
    out["process"] = slab_process(job4, R, fail)
    check(not failures, f"slabs: {len(failures)} checks failed: "
                        f"{failures}")
    # jobs 1b and 5, alone on the cards (beside the launch, job 4 came
    # near its limit), under a budget of their own
    budget(SLAB_FULLGAP_BUDGET_S)
    out["precond"] = slab_preconds(R, ops_spec, emu)
    t = time.perf_counter()
    out["fullgap"] = slab_fullgap(R)
    out["fullgap_s"] = time.perf_counter() - t
    return out


def slab_preconds(R: int, ops_spec: dict, emu: dict) -> dict:
    """Job 1b: job 1's V and M with each of SLAB_PRECONDS as the
    Poisson-row solve (`slab_precond_specs`) on R ranks, one per card, and
    on one card (a rank's card alone, in the same launch, after the slab
    jobs), held by `_slab_precond_vs_one`; job 1's probe (`emu`) for M's
    count rounding. The same ranks emulated on one card hold each solve's
    V on every run (`slabs_one_rank_precond`)."""
    from fedm_tpu_torch.parallel import rank_checks, ranks

    specs = slab_precond_specs(ops_spec)
    refs = [(f"plain_{k}", "slab_ops", v) for k, v in specs.items()]
    jobs = ([(k, "slab_ops", v) for k, v in specs.items()]
            + [(key, "on_one_rank", {"rank": (i + 1) % R, "worker": name,
                                     "spec": spec})
               for i, (key, name, spec) in enumerate(refs)])
    t = time.perf_counter()
    res = ranks.launch(rank_checks.several, R, "cuda", (jobs,),
                       timeout=SLAB_LAUNCH_S)
    out = {"launch_s": time.perf_counter() - t}
    one = {key: next(r[key] for r in res if r[key] is not None)
           for key, _, _ in refs}
    failures = []

    def fail(ok, msg):
        if not ok:
            log(f"slabs: FAILED CHECK: {msg}")
            failures.append(msg)

    for name in specs:
        out[name] = _slab_precond_vs_one(name, [r[name] for r in res],
                                         one[f"plain_{name}"], emu, fail)
    check(not failures, f"slabs: mg and the Chebyshev solve: "
                        f"{len(failures)} checks failed: {failures}")
    return out


def _cards_launches(out: dict) -> dict:
    """K1's launches in phase 11, per rank: the extended and the
    streamer's distributed steps, the sweep's attempts; dd_scale's."""
    return {"extended": out["extended"]["k1_launches"],
            "streamer": out["streamer"]["k1_launches"],
            "sweep": out["sweep"]["k1_launches"],
            "dd_scale": out["dd_scale"]["k1_launches"]}


def _slab_launches(out: dict) -> dict:
    """K1's launches in phase 12, per rank: the restart's advances, the
    window's move and advances, and the full gap's advances under mg (job
    5, on the R ranks and on one card)."""
    return {"restart": out["restart"]["k1_launches"],
            "window": out["window"]["k1_launches"],
            "fullgap_mg": out["fullgap"]["ranks"]["k1_launches"],
            "fullgap_mg_one_card": out["fullgap"]["one_card"]["k1_launches"]}


def window_lane(k1, card) -> int:
    """`--only window`: phases 4 and 4b, their results as one JSON line."""
    phase("4 fresh window")
    window, wmodel, moved = fresh_window(k1, card)
    phase("4b rescue")
    rescue_out = rescue(k1, card, wmodel, moved)
    signal.alarm(0)
    print(json.dumps({"fresh_window": window, "rescue": rescue_out}))
    return 0


def finish_lane(job: dict) -> dict:
    """The results line of a `--only` run started by `start_process`,
    its log copied into this one's."""
    job["waiter"].join(max(1.0, BUDGET_S - (time.perf_counter()
                                            - job["t0"])))
    for line in (job["tmp"] / "stderr").read_text().splitlines():
        print(f"  | {line}", file=sys.stderr)
    sys.stderr.flush()
    return json.loads(finish_process(job, BUDGET_S).strip()
                      .splitlines()[-1])


def cards_only(k1, kind: str, count: int, card: str, only: str) -> int:
    """`--only cards` (phase 11, then phase 12) or `--only slabs` (phase
    12 alone), after phases 0 and 1; K1's row from phase 11's stacked
    table on card 0, or from phase 12's electrode ranks."""
    check(count >= 2, f"--only {only} needs two or more cards ({count})")
    out = None
    if only == "cards":
        # phase 12 after phase 11, each with its own budget: run side by
        # side, their ranks' hosts contended and phase 12's launch ran past
        # its limit on four H100s (F4)
        phase("11 cards")
        budget(CARDS_BUDGET_S)
        out = cards(k1, count, None)
    phase("12 slabs")
    budget(SLABS_BUDGET_S)
    slab_out = slabs(k1, count)
    signal.alarm(0)
    launches = {} if out is None else {"cards": _cards_launches(out)}
    launches["slabs"] = _slab_launches(slab_out)
    n = sum(sum(v) if isinstance(v, list) else v
            for path in launches.values() for v in path.values())
    if out is not None:
        case = out["k1_case"]
        err = max(case["max_abs_err"],
                  out["extended"]["k1_rank1"]["max_abs_err"])
    else:
        case = None
        err = 0.0
    err = max([err] + [k["max_abs_err"] for k in slab_out["k1_ranks"]
                       if k is not None])
    if case is None:
        # K1 timed at the electrode facets' table of the main path
        case = slab_k1_case(k1)
    kernels = [{
        "name": "ell_scatter", "route": "cuda",
        "source": "fedm_tpu_torch/csrc/ell_scatter.cu",
        "replaces": "fedm_tpu/ops/pallas_scatter.py:34",
        "launches": n, "launches_by_path": launches,
        "max_abs_err": max(err, case["max_abs_err"]),
        "ms": case["ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": "bytes",
        "library_ms": case["library_ms"], "floor_ms": case["floor_ms"],
        "event_timed": devtime.event_fallbacks, "cases": [case]}]
    print(json.dumps({"kernels": kernels, "cards": out, "slabs": slab_out},
                     default=str))
    for line in _smi_lines():
        print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


def slab_k1_case(k1) -> dict:
    """K1's compact form at the main path's electrode facet table (C = 3,
    float32), timed against its plain version (`--only slabs`)."""
    from fedm_tpu_torch.parallel import rank_checks

    model = rank_checks.slab_model(slab_specs()[0], torch.device("cuda"))
    fb = model.system.facet_kernels[0][0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat = torch.randn((fb.dofs.numel(), 3), generator=gen, device="cuda")
    flush = l2_flush()
    return k1_compact_case("facet compact C=3 float32", fb.scatter_rows,
                           fb.scatter_idx, fb.gather_idx,
                           fb.dofs.reshape(-1).long(), flat,
                           model.space.n_dofs, k1, gen, flush)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the port's smoke test on "
                                             "the card(s)")
    ap.add_argument("--only", choices=["cards", "slabs", "window"],
                    default=None,
                    help="cards: phases 0, 1, 11 and 12 (the multi-card "
                         "checks); slabs: phases 0, 1 and 12 alone; "
                         "window: phases 0, 1, 4 and 4b, their results "
                         "as one JSON line (the full run starts it beside "
                         "phases 5-10)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _on_alarm)
    budget(BUDGET_S)

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

    if args.only == "window":
        return window_lane(k1, card)
    if args.only is not None:
        return cards_only(k1, kind, count, card, args.only)

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

    # the main path's system on one z-slab (the one-card part of phase 12;
    # the model is done with: use_gspmd leaves it on the slab), after the
    # solves this slice adds, on copies of it
    phase("12 slabs")
    slabs_precond = slabs_one_rank_precond(model, k1)
    slabs_one = slabs_one_rank(model, state)

    # Phases 4 and 4b (the fresh window and its rescue) run in a process of
    # their own (`--only window`) beside 5-10, and each process a phase
    # starts runs beside the phase: host work, mostly, on the same card.
    # `stop_processes` ends whatever still runs after a failure.
    del model, driver, state
    jobs = []
    try:
        window_job = start_process(["chip_smoke", "--only", "window"],
                                   "window_lane")
        jobs.append(window_job)
        phase("5 glow")
        glow_out = glow(k1, card)

        phase("6 options")
        options_out = options(k1, card)

        # phase 8 runs before 7, whose 2D run takes the length the budget
        # left allows
        phase("8 extended")
        jobs.append(start_extended_entry())
        ext_out = extended(k1, card, jobs[-1])

        phase("9 sweep")
        sweep_out, sweep_states = sweep(k1, card)

        # the processes of phases 9a, 10 and 13 run beside 9b
        example_job, dd_job = start_streamer_example(), start_dd_scale()
        series_jobs = start_postprocess()
        jobs += [example_job, dd_job] + series_jobs
        phase("9b sweep options")
        sweep_options_out = sweep_options(k1, card, sweep_states)
        phase("9a streamer example")
        example_out = streamer_example(example_job, card)
        phase("13 post-processing")
        series_out = postprocess(series_jobs, card)
        phase("10 dd_scale")
        dd_out = dd_scale(card, job=dd_job)
        phase("4 fresh window")
        lane = finish_lane(window_job)
        window, rescue_out = lane["fresh_window"], lane["rescue"]

        phase("7 tof")
        jobs.append(start_tof_quick())
        tof_out = tof(k1, card, jobs[-1])
    finally:
        stop_processes(jobs)

    phase("11 cards")
    cards_out = None
    if count < 2:
        print(f"11 cards: not run, {count} device", file=sys.stderr,
              flush=True)
    else:
        budget(CARDS_BUDGET_S)
        cards_out = cards(k1, count, dd_out)
    phase("12 slabs")
    slabs_out = None
    if count < 2:
        print(f"phase 12 slabs: R>1 not run, {count} device",
              file=sys.stderr, flush=True)
    else:
        budget(SLABS_BUDGET_S)
        slabs_out = slabs(k1, count)
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
                     + sum(sum(o["launches"].values())
                           for o in sweep_options_out.values())
                     + dd_out["k1_launches"]
                     + sum(slabs_precond["k1_launches"].values())
                     + (0 if slabs_out is None else sum(
                         sum(v) for v in
                         _slab_launches(slabs_out).values()))),
        "launches_by_path": {"restart": launches,
                             "fresh_window": window["launches"],
                             "rescue": rescue_out["launches"],
                             "glow": glow_out["launches"],
                             "options": dict(option_launches),
                             "tof_1d": tof_out["1d_launches"],
                             "tof_2d": tof_out["2d_launches"],
                             "extended": ext_out["launches"],
                             "sweep": sweep_out["launches"],
                             "sweep_options": {
                                 k: o["launches"]
                                 for k, o in sweep_options_out.items()},
                             "dd_scale": dd_out["k1_launches"],
                             "cards": (None if cards_out is None
                                       else _cards_launches(cards_out)),
                             "slabs_precond": slabs_precond["k1_launches"],
                             "slabs": (None if slabs_out is None
                                       else _slab_launches(slabs_out))},
        "sweep_launches_by_shape": sweep_out["launches_by_shape"],
        "sweep_options_launches_by_shape": {
            k: o["launches_by_shape"] for k, o in sweep_options_out.items()},
        "extended_launches_by_shape":
            ext_out["distributed_step"]["launches_by_shape"],
        "glow_launches_by_shape": glow_out["launches_by_shape"],
        "max_abs_err": max([c["max_abs_err"] for c in
                            cases + compact + glow_cases + tof_cases
                            + ext_cases + sweep_cases]
                           + [slabs_precond["k1_coarse_level"]
                              ["max_abs_err"]]),
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
        "sweep_options": sweep_options_out,
        "streamer_example": example_out, "post_processing": series_out,
        "dd_scale": dd_out,
        "cards": cards_out, "slabs": {"one_rank": slabs_one,
                                      "precond": slabs_precond,
                                      "cards": slabs_out}}, default=str))
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
