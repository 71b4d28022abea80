"""Rank workers that hold the ranked code to the stacked one: each runs
on every rank of a `ranks.launch` (or a one-rank group), builds its
inputs itself from a seed, and returns its rank's rows and numbers on the
host, for the caller to put together and compare with one process's.
They live in the package, so that the spawned ranks import neither a
test module nor JAX.

    halo(group, spec)        the halo fill and reduce on seeded payloads
    reductions(group, spec)  `_dot`, `_norm`, their batched forms, finite
    dd(group, spec)          a distributed model's residual, node blocks
                             and one step, with its Newton/Krylov log
    sweep(group, spec)       a `BatchedSweep` over the ranks
    skip_collective(group)   rank 0 reduces, the others do not
    stall(group, seconds)    every rank sleeps (a run past its limit)
    several(group, jobs)     the workers named in `jobs`, in order, in one
                             launch
    slab_ops(group, spec)    a structured model on z-slabs: its operators,
                             one V-cycle and one z-line solve, this rank's
                             rows, and a residual without the halo row
                             from below (the control)
    slab_march(group, spec)  a structured model on z-slabs (or, without a
                             group, on one card) through a plan of
                             advances, window moves and steps
    krylov_spread(group, spec)  one card's march again from perturbed
                             states (the port's own spread of its counts)
    slab_march_one_rank(group, spec)  the march on one slab of a one-rank
                             group
    shard(group, spec)       the round-1 sharded system: residual, node
                             blocks and one step
    on_one_rank(group, spec) another worker on one rank's card, without
                             the group (a one-card reference)
    slab_units(group, spec)  the slab pieces of a seeded grid
    bagheri_models(group, spec)  the entry point's models on z-slabs
"""

from __future__ import annotations

import dataclasses
import time
from unittest import mock

import numpy as np
import torch

from ..devtime import card_of, on_card
from .ranks import Group, part_devices


def _streamer(spec: dict, device):
    from ..models.streamer import StreamerConfig, StreamerModel

    return StreamerModel(StreamerConfig(**spec.get("cfg", {})),
                         device=device)


def halo(group: Group, spec: dict) -> dict:
    """The streamer's DD (spec: cfg, n_parts, seed) on this rank's parts:
    `_halo_fill` of this rank's rows of a seeded [N*n_own_max, 3] payload,
    and `_halo_reduce` of its rows of a seeded [N*n_ext, 3] one."""
    m = _streamer(spec, group.device)
    d = m.distribute(part_devices(spec["n_parts"], group), group)
    rng = np.random.default_rng(spec.get("seed", 0))
    x = rng.standard_normal((d.n_dofs_dist, 3))
    r = rng.standard_normal((d.n_parts * d.n_ext, 3))
    ext = slice(d.part0 * d.n_ext, (d.part0 + d.n_local) * d.n_ext)
    put = lambda a: torch.as_tensor(a, device=group.device)  # noqa: E731
    return {"rank": group.rank, "card": card_of(group.device),
            "fill": d._halo_fill(put(x[d.row0:d.row0 + d.n_rows])).cpu(),
            "reduce": d._halo_reduce(put(r[ext])).cpu()}


def _split(a: np.ndarray, group: Group, axis: int = 0):
    """This rank's block of `a` along `axis` (equal blocks)."""
    n = a.shape[axis] // group.size
    return np.take(a, np.arange(group.rank * n, (group.rank + 1) * n),
                   axis=axis)


def reductions(group: Group, spec: dict) -> dict:
    """`_dot`, `_norm` and `finite` of seeded vectors (spec: n rows, B
    members, seed) whose rows are split over the ranks, and `dot_b`,
    `norm_b` and `finite_b` of members split over them as the sweep splits
    them (each member on one rank, the results gathered): every rank's
    values, which must be one process's."""
    from ..solvers.linear import _dot, _norm, dot_b, finite, finite_b, norm_b

    rng = np.random.default_rng(spec.get("seed", 0))
    n, B = spec["n"], spec.get("B", 4)
    scale = 10.0 ** rng.integers(-30, 30, size=(n, 1))
    a = rng.standard_normal((n, 3)) * scale
    b = rng.standard_normal((n, 3))
    ab = rng.standard_normal((B, n, 2)) * scale[None]
    bb = rng.standard_normal((B, n, 2))
    put = lambda x: torch.as_tensor(x, device=group.device)  # noqa: E731
    la, lb = put(_split(a, group)), put(_split(b, group))
    lab, lbb = put(_split(ab, group)), put(_split(bb, group))
    nan = la.clone()
    if group.rank == group.size - 1:
        nan[-1, 0] = float("nan")
    inf_b = ab.copy()
    inf_b[1, 0, 0] = np.inf
    gather = lambda x: group.all_gather_rows(x).cpu().numpy()  # noqa: E731
    return {"dot": float(_dot(la, lb, group)),
            "norm": float(_norm(la, group)),
            "dot_b": gather(dot_b(lab, lbb)),
            "norm_b": gather(norm_b(lab)),
            "finite": (finite(la, group), finite(nan, group)),
            "finite_b": gather(finite_b(put(_split(inf_b, group))).to(
                torch.int64)).astype(bool)}


def _counting(counts: dict, log: list, name: str, fn):
    """`fn`, adding to counts[name] its Krylov iterations (the third item
    it returns), or one per Newton iteration, and logging its numbers."""
    def run(*args, **kw):
        out = fn(*args, **kw)
        if name == "newton_iteration":
            counts[name] = counts.get(name, 0) + 1
            log.append((name, float(out[1]), float(out[2]), bool(out[3])))
        else:
            counts[name] = counts.get(name, 0) + int(out[2])
            log.append((name, int(out[2]), float(out[1])))
        return out

    return run


def _model(spec: dict, device):
    if spec["model"] == "streamer":
        return _streamer(spec, device)
    from pathlib import Path

    from ..examples import extended_scheme

    args = extended_scheme.parse_args(["--device", str(device),
                                       *spec.get("argv", [])])
    return extended_scheme.build_model(args, Path(spec["tree"]),
                                       spec["tree_name"])


def _dropping_remote(d):
    """`d._roll` with the rows that the reverse exchange receives from
    other ranks dropped (the control: no cross-rank reverse exchange)."""
    roll = d._roll

    def run(payload, shift, move):
        out = roll(payload, shift, move)
        if shift < 0 and move is not None:
            for j in move[2].values():
                out[j] = 0.0
        return out

    return run


def _step(d, model, s, p, device):
    """One step of the distributed system from the state `s`, with its
    Newton/Krylov counts and log and K1's launches (counts set to 0 just
    before, read just after)."""
    from ..ops import ell_scatter as k1
    from ..solvers import newton

    counts, log = {}, []
    patches = {name: _counting(counts, log, name, getattr(newton, name))
               for name in ("newton_iteration", "bicgstab", "gmres")}
    with mock.patch.multiple(newton, **patches):
        k1.LAUNCHES.clear()

        def go():
            aux = (model._update_aux(s.u) if spec_is_generic(model) else {})
            return d.step(s.u, s.u, s.u_old1, aux, p)

        (u1, info), secs = on_card(go, device)
        launches = dict(k1.LAUNCHES)
    return {"u": u1.cpu(), "converged": bool(info.converged),
            "iters": int(info.iters), "res_norm": float(info.res_norm),
            "res0_norm": float(info.res0_norm),
            "newton_iterations": counts.get("newton_iteration", 0),
            "bicgstab_iterations": counts.get("bicgstab", 0),
            "gmres_iterations": counts.get("gmres", 0), "log": log,
            "s": secs,
            "launches": {" ".join(map(str, k)): n
                         for k, n in launches.items()}}


def spec_is_generic(model) -> bool:
    return hasattr(model, "n_species")


def dd(group: Group, spec: dict) -> dict:
    """A distributed model on this rank's parts (spec: model "streamer"
    with cfg, or "extended" with tree, tree_name and argv; n_parts):
    its layout, the float64 residual and the node blocks at the initial
    state (this rank's rows), and, as spec asks, one step (`step`), after
    `enable_distributed_elliptic(eq)` (`elliptic`), the residual and the
    step without the cross-rank reverse exchange (`control`), and on a
    card K1 against its plain version at this rank's cell table
    (`k1`)."""
    from ..model.system import StepParams

    dev = group.device
    model = _model(spec, dev)
    d = model.distribute(part_devices(spec["n_parts"], group), group)
    s = model.initial_state()
    aux = model._update_aux(s.u) if spec_is_generic(model) else {}
    p = StepParams(s.t + s.dt, s.dt, s.dt_old)
    F = d.residual(s.u, s.u, s.u_old1, p, aux=aux)
    B = d.operators(s.u, s.u_old1, p, aux=aux).jacobian_blocks(
        torch.zeros_like(s.u))
    out = {"rank": group.rank, "card": card_of(dev), "row0": d.row0,
           "n_rows": d.n_rows, "n_own_max": d.n_own_max,
           "n_ghost_max": d.n_ghost_max, "shifts": list(d._shifts),
           "F": F.cpu(), "B": B.cpu(), "u0": s.u.cpu(),
           "aux": {k: v.cpu() for k, v in aux.items()
                   if isinstance(v, torch.Tensor) and v.dim() >= 1
                   and v.shape[0] == d.n_rows}}
    del B
    if spec.get("k1") and dev.type == "cuda":
        out["k1"] = _k1_at(d, dev)
    if spec.get("elliptic") is not None:
        d.enable_distributed_elliptic(spec["elliptic"])
    if spec.get("step"):
        out["step"] = _step(d, model, s, p, dev)
    if spec.get("control"):
        with mock.patch.object(d, "_roll", _dropping_remote(d)):
            out["control_F"] = d.residual(s.u, s.u, s.u_old1, p,
                                          aux=aux).cpu()
            if spec.get("step"):
                out["control_step"] = _step(d, model, s, p, dev)
    return out


def _k1_at(d, dev) -> dict:
    """K1's compact form against its plain version at this rank's stacked
    cell table, at the residual's width (C = n_eq), float64."""
    from ..ops import ell_scatter as k1

    b = d._batches[0][0]
    gen = torch.Generator(device=dev).manual_seed(12)
    C = d.n_eq
    flat = torch.randn((b.dofs.numel(), C), generator=gen, device=dev,
                       dtype=torch.float64)
    out0 = torch.randn((d.n_local * d.n_ext, C), generator=gen, device=dev,
                       dtype=torch.float64)
    before = k1.launch_count("ell_scatter_add_")
    got = k1.ell_scatter_add_(out0.clone(), flat, b.scatter_idx,
                              b.scatter_rows)
    launched = k1.launch_count("ell_scatter_add_") - before
    ref = k1.ell_scatter_add_ref(out0.clone(), flat, b.scatter_idx,
                                 b.scatter_rows)
    return {"case": f"rank cell table C={C} float64",
            "n_rows": int(b.scatter_idx.shape[0]),
            "max_val": int(b.scatter_idx.shape[1]),
            "max_abs_err": float((got - ref).abs().max()),
            "scale": float(ref.abs().max()), "launched": launched,
            "device": str(got.device)}


def sweep(group: Group, spec: dict) -> dict:
    """A `BatchedSweep` over the group (spec: cfg of the StreamerConfig,
    amps, attempts, monitor; `start`, a SweepState's arrays, in place of
    the members' own initial states): every member's initial state, then
    `attempts` lockstep attempts; the whole SweepState's record after
    each (every rank holds all of it), the final states, each attempt's
    wall time on this rank's card and K1's launches."""
    from ..models.streamer import StreamerConfig, StreamerModel
    from ..ops import ell_scatter as k1
    from .sweep import BatchedSweep

    dev = group.device
    cfg = StreamerConfig(**spec.get("cfg", {}))
    model = StreamerModel(cfg, device=dev)
    amps = spec["amps"]
    sw = BatchedSweep(model.system, monitor_idx=spec.get("monitor", 1),
                      ttol=cfg.ttol, dt_min=cfg.dt_min, dt_max=cfg.dt_max,
                      batch_sharding=part_devices(len(amps), group),
                      group=group)
    mine = sw._members(len(amps))
    if "start" in spec:
        from ..convert import sweep_state_from_arrays

        st = sweep_state_from_arrays(spec["start"], device=dev)
    else:
        states = [StreamerModel(dataclasses.replace(cfg, seed_amplitude=a),
                                device=dev).initial_state()
                  if mine.start <= i < mine.stop else None
                  for i, a in enumerate(amps)]
        st = sw.from_states(states)
    initial = record(st)
    records, secs = [], []
    k1.LAUNCHES.clear()
    for _ in range(spec.get("attempts", 3)):
        st, t = on_card(lambda st=st: sw.attempt(st, {}), dev)
        secs.append(t)
        records.append(record(st))
    return {"rank": group.rank, "card": card_of(dev), "members": mine,
            "initial": initial, "records": records, "u": st.u.cpu(),
            "attempt_s": secs,
            "launches": sum(k1.LAUNCHES.values())}


def record(st) -> dict:
    """A SweepState's numbers: the counts, t, dt, max_error and the
    members' per-column 2-norms."""
    return {"n_accepted": st.n_accepted.tolist(),
            "n_rejected": st.n_rejected.tolist(), "t": st.t.tolist(),
            "dt": st.dt.tolist(), "max_error": st.max_error.tolist(),
            "u_norms": torch.linalg.vector_norm(
                st.u.double(), dim=1).tolist()}


def skip_collective(group: Group) -> float:
    """Rank 0 all-reduces; every other rank returns without: the launch
    must fail (the collective times out or loses its peers)."""
    if group.rank == 0:
        return float(group.all_reduce(torch.ones(1, device=group.device)))
    return 0.0


def stall(group: Group, seconds: float) -> None:
    """Every rank sleeps `seconds`: a launch with a shorter time limit
    must kill its ranks and raise."""
    time.sleep(seconds)


def several(group: Group, jobs: list) -> dict:
    """Run the workers of `jobs`, (key, worker name, spec) in order, on
    one launch's ranks: {key: that worker's result}."""
    return {key: globals()[name](group, spec) for key, name, spec in jobs}


# -- z-slabs (`CoupledSystem.use_gspmd`) and the round-1 shard ----------------


def slab_model(spec: dict, device):
    """A structured streamer model (spec: `bagheri_argv`, the arguments of
    `bagheri_run` whose model to build, or `cfg` and `newton`, the
    StreamerConfig's and NewtonConfig's keywords, and `float32`), with the
    structured assembly engaged, and the Poisson-row preconditioner of
    spec `poisson` (`_poisson`)."""
    from ..models.streamer import StreamerConfig, StreamerModel
    from ..solvers.newton import NewtonConfig

    if "bagheri_argv" in spec:
        from .. import bagheri_run

        mg = ["--precond", "mg"] if spec.get("poisson") == "mg" else []
        args = bagheri_run.parse_args([*spec["bagheri_argv"], *mg, "--out",
                                       "-", "--device", str(device)])
        corr = (spec["corridor"] if "corridor" in spec else
                bagheri_run.window_corr(1e-2, args.window_span,
                                        args.window_dz))
        return _poisson(spec, bagheri_run.build_models(args,
                                                       tuple(corr))[0])
    kw = dict(spec.get("cfg", {}))
    if spec.get("poisson") == "mg":
        kw["poisson_precond"] = "mg"
    if "newton" in spec:
        kw["newton"] = NewtonConfig(**spec["newton"])
    if spec.get("float32"):
        kw["dtype"] = torch.float32
    m = StreamerModel(StreamerConfig(**kw), device=device)
    m.system.use_gather_scatter()
    return _poisson(spec, m)


def _poisson(spec: dict, m):
    """`m` with spec `poisson`'s Poisson-row preconditioner installed:
    "mg" the point-smoothed `GeometricMultigrid` (the model was built with
    poisson_precond="mg"), "chebyshev" the Chebyshev solve
    (`enable_elliptic_precond(2)`, as the JAX package installs it),
    "geometric" the model's `GeometricMultigrid` (z-line smoothed under
    "mg-zline") in place of the structured V-cycle; else the model's
    own."""
    kind = spec.get("poisson")
    if kind == "chebyshev":
        m.system.enable_elliptic_precond(2)
    elif kind == "geometric":
        m.system.enable_elliptic_precond(2, mg=m._geometric_mg())
    elif kind not in (None, "mg"):
        raise ValueError(f"poisson {kind!r}")
    return m


def bagheri_models(group, spec: dict) -> dict:
    """`bagheri_run.build_models` on this rank's z-slabs (spec:
    `bagheri_argv`, with the corridor of a run without --window-dz): each
    model's slab Poisson-row solve and this rank's node rows."""
    from .. import bagheri_run

    args = bagheri_run.parse_args([*spec["bagheri_argv"], "--out", "-",
                                   "--device", str(group.device)])
    models = [m for m in bagheri_run.build_models(
        args, (0.0, 1.08e-2, args.dz), group) if m is not None]
    return {"rank": group.rank, "rows": models[0].system.slabs.layout.rows(
                group.rank),
            "solves": [type(m.system._ell[1].__self__).__name__
                       for m in models]}


def _slab_state(spec: dict, m, device):
    """The start (spec: `ckpt`, a checkpoint path; `u`, whole-grid numpy
    fields u, u_old, u_old1 with t, dt, dt_old; else the model's initial
    state), as the system holds it."""
    if "ckpt" in spec:
        from ..io import load_checkpoint

        st = load_checkpoint(spec["ckpt"], device=device)
    elif "u" in spec:
        from ..convert import state_from_arrays

        st = state_from_arrays({"max_error": [1.0, 1.0, 1.0],
                                "n_accepted": 0, "n_rejected": 0,
                                **spec["u"]}, device)
    else:
        return m.initial_state()
    place = m.system.place_state
    st.u, st.u_old, st.u_old1 = (place(st.u), place(st.u_old),
                                 place(st.u_old1))
    return st


def _dropping_below(slabs):
    """`slabs.halo` with every row received from below zeroed (the
    control: a halo exchange that drops one row)."""
    halo = slabs.halo

    def run(x, dim=0, below=True, above=True, zeros=False):
        out = halo(x, dim, below, above, zeros)
        if below and slabs.group.rank > 0:
            out.narrow(dim, 0, 1).zero_()
        return out

    return run


def _poisson_control(solver):
    """The control of a slab Poisson-row solve `solver`, or None: for
    `SlabGeometricMG` the V-cycle whose point smoother drops the halo row
    from below, for `SlabChebyshev` the solve with lmax scaled by
    (1 + 1e-6)."""
    from ..solvers.chebyshev import ChebyshevSolve
    from .slabs import SlabChebyshev, SlabGeometricMG

    if isinstance(solver, SlabChebyshev):
        return ChebyshevSolve(solver.A, solver.dtilde,
                              solver.lmax * (1 + 1e-6), solver.degree,
                              solver.ratio).solve
    if not isinstance(solver, SlabGeometricMG):
        return None
    smooth = solver._smooth

    def smooth_without_below(k, R):
        with mock.patch.object(solver.slabs, "halo",
                               _dropping_below(solver.slabs)):
            return smooth(k, R)

    def run(r):
        with mock.patch.object(solver, "_smooth", smooth_without_below):
            return solver.precond(r)

    return run


def slab_ops(group, spec: dict) -> dict:
    """`ops_record` of a structured model (`slab_model`) at a state
    (`_slab_state`, on one card), on this rank's z-slab (on one card
    without a group; spec `device`)."""
    dev = group.device if group is not None else torch.device(
        spec["device"])
    m = slab_model(spec, dev)
    return ops_record(m, _slab_state(spec, m, dev), group, spec)


def ops_record(m, st, group, spec: dict, smoother=None) -> dict:
    """A structured model `m` at the whole state `st` and its next step's
    parameters, on this rank's z-slab of `group` (`use_gspmd`; one card
    without a group): the residual at delta = u - u_old in the compute
    type and in float64, J v and the node blocks there, one V-cycle (or
    the model's Poisson-row solve), one z-line solve (`ZLineSmoother`, 2
    line solves, on the same mesh) and one application of the whole
    preconditioner, of seeded vectors (spec `seed`); with a group also
    the residual without the halo row from below (`control_F`) and, on a
    card whose rank holds electrode facets, K1 at its facet table against
    its plain version, and the control of the slab Poisson-row solve
    (`control_V`, `_poisson_control`). This rank's rows, on the host.
    Spec `ops`: the operators to record ("F", "F64", "Jv", "B", "V",
    "zline", "M"; default all; `control_F` goes with "F").
    `smoother`: that `ZLineSmoother`, built already (on the whole grid,
    as here)."""
    from unittest import mock as _mock

    from ..model.system import StepParams
    from ..parallel.slabs import SlabLineSolver
    from ..solvers.linesmoother import ZLineSmoother

    dev = st.u.device
    sysm = m.system
    want = set(spec.get("ops", ("F", "F64", "Jv", "B", "V", "zline", "M")))
    if "zline" in want:
        sm = smoother or ZLineSmoother(
            sysm.masked_stiffness_op(2), m._node_grid(m.space),
            m.space.n_dofs, n_iter=2, dtype=m.batch.dtype, device=dev)
        zline = sm.solve
    n_i = sysm.cell_batch._structured[0] + 1
    rows = (0, m.space.n_dofs // n_i)
    if group is not None:
        sysm.use_gspmd(group)
        if "zline" in want:
            zline = SlabLineSolver(sm, sysm.slabs,
                                   sysm.masked_stiffness_op(2)).solve
        rows = (sysm.slabs.lo, sysm.slabs.hi)
    place = sysm.place_state
    u, u_old = place(st.u), place(st.u_old)
    p = StepParams(st.t + st.dt, st.dt, st.dt_old)
    rng = np.random.default_rng(spec.get("seed", 0))
    n = m.space.n_dofs
    put = lambda a: place(torch.as_tensor(a, device=dev))  # noqa: E731
    v = put(rng.standard_normal((n, 3))).to(sysm.dtype)
    r = put(rng.standard_normal(n)).to(sysm.dtype)
    r3 = put(rng.standard_normal((n, 3))).to(sysm.dtype)
    ops = sysm.operators(u, u_old, p)
    delta = (u - u_old).to(ops.dtype)
    record = {
        "F": lambda: ops.residual(delta),
        "F64": lambda: sysm.operators(u, u_old, p, torch.float64
                                      ).residual(delta.double()),
        "Jv": lambda: ops.jacobian_action(delta)(v),
        "B": lambda: ops.jacobian_blocks(delta),
        "V": lambda: sysm._ell[1](r),
        "zline": lambda: zline(r),
        "M": lambda: sysm.block_precond_builder(ops)(delta)(r3)}
    out = {"rank": group.rank if group is not None else 0,
           "card": card_of(dev), "rows": rows,
           **{k: f().cpu() for k, f in record.items() if k in want},
           "poisson_solve": type(sysm._ell[1].__self__).__name__,
           "grads_shape": tuple(ops.batches[0][0].grads.shape),
           "facet_rows": [int(b.dofs.shape[0]) for b, _ in ops.batches[1:]]}
    if spec.get("profile_iters"):
        out["krylov"] = _profiled_krylov(sysm, ops, delta, group,
                                         spec["profile_iters"])
    if group is not None:
        if "F" in want:
            with _mock.patch.object(sysm.slabs, "halo",
                                    _dropping_below(sysm.slabs)):
                out["control_F"] = sysm.operators(
                    u, u_old, p).residual(delta).cpu()
        control_V = _poisson_control(sysm._ell[1].__self__)
        if control_V is not None:
            out["control_V"] = control_V(r).cpu()
        if dev.type == "cuda" and len(sysm.slab_batches) > 1:
            out["k1"] = _k1_facets(sysm.slab_batches[1][0], dev)
    return out


def _profiled_krylov(sysm, ops, delta, group, n: int) -> dict:
    """`n` BiCGStab iterations of the preconditioned Jacobian M J (each
    rank's rows, reductions over `group`): ms per iteration on the host
    clock, the group's collectives per iteration, and on a card the
    device's busy time (the union of its kernels' intervals, from one
    profiler trace) and idle share."""
    from contextlib import ExitStack

    from torch.profiler import ProfilerActivity, profile

    from ..solvers.linear import bicgstab

    dev = delta.device
    J, M = ops.jacobian_action(delta), sysm.block_precond_builder(ops)(delta)
    rhs = M(-ops.residual(delta))

    def op(v):
        return M(J(v))

    bicgstab(op, rhs, tol=1e-30, maxiter=2, group=group)
    coll = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with ExitStack() as stack:
        if group is not None:
            for pt in _plan_counts(group, coll):
                stack.enter_context(pt)
        with profile(activities=acts) as prof:
            (_, _, iters), wall = on_card(lambda: bicgstab(
                op, rhs, tol=1e-30, maxiter=n, group=group), dev)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy /= 1e6
    iters = max(int(iters), 1)
    return {"iterations": iters, "wall_s": wall,
            "ms_per_iteration": 1e3 * wall / iters,
            "collectives_per_iteration": {k: v / iters
                                          for k, v in coll.items()},
            "busy_s": busy if spans else "not measured",
            "idle_share": 1.0 - busy / wall if spans else "not measured"}


def _k1_facets(b, dev) -> dict:
    """K1's compact form against its plain version at a rank's facet
    table, at the residual's width (C = 3), float32."""
    from ..ops import ell_scatter as k1

    gen = torch.Generator(device=dev).manual_seed(12)
    flat = torch.randn((b.dofs.numel(), 3), generator=gen, device=dev)
    out0 = torch.randn((b.n_dofs, 3), generator=gen, device=dev)
    before = k1.launch_count("ell_scatter_add_")
    got = k1.ell_scatter_add_(out0.clone(), flat, b.scatter_idx,
                              b.scatter_rows)
    launched = k1.launch_count("ell_scatter_add_") - before
    ref = k1.ell_scatter_add_ref(out0.clone(), flat, b.scatter_idx,
                                 b.scatter_rows)
    return {"rows": int(b.scatter_idx.shape[0]),
            "max_val": int(b.scatter_idx.shape[1]),
            "max_abs_err": float((got - ref).abs().max()),
            "scale": float(ref.abs().max()), "launched": launched,
            "device": str(got.device)}


def _plan_counts(group, counts: dict):
    """Patches of `group`'s collectives adding their calls to `counts`."""
    def counted(name, fn):
        def run(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return run

    return [mock.patch.object(group, name, counted(name, getattr(group,
                                                                 name)))
            for name in ("exchange", "all_gather_rows", "all_reduce")]


def slab_march(group, spec: dict) -> dict:
    """A structured model (`slab_model`) from a state (`_slab_state`)
    through `spec["plan"]`, on this rank's z-slab (one card without a
    group; spec `device`): "advance" (the model's adaptive driver, with
    spec `driver` options), ("move", corridor) (`move_window`) or
    ("step", (t, dt, dt_old)) (one `system.step` from the state). Per
    item: t, dt, the counts, the whole state's column 2-norms, the Newton
    and Krylov iterations, the wall time on this rank's card, K1's
    launches and the group's collectives (counted from 0 before the
    item); then the whole final state (on rank 0). Spec `perturb`
    (eps, seed, i): before plan item i, u scaled by (1 + eps * noise),
    standard normal noise over the whole grid from `seed`."""
    from contextlib import ExitStack

    from ..model.system import StepParams
    from ..ops import ell_scatter as k1
    from ..solvers import newton

    dev = group.device if group is not None else torch.device(
        spec["device"])
    m = slab_model(spec, dev)
    if group is not None:
        m.system.use_gspmd(group)
    st = _slab_state(spec, m, dev)
    driver = m.make_driver(**spec.get("driver", {}))
    pert = spec.get("perturb")
    rows = []
    counts, log, coll = {}, [], {}
    patches = {name: _counting(counts, log, name, getattr(newton, name))
               for name in ("newton_iteration", "bicgstab", "gmres")}
    for i, item in enumerate(spec["plan"]):
        if pert is not None and i == pert[2]:
            st = _perturbed(m.system, st, pert[0], pert[1])
        counts.clear()
        log.clear()
        coll.clear()
        k1.LAUNCHES.clear()
        with ExitStack() as stack:
            stack.enter_context(mock.patch.multiple(newton, **patches))
            if group is not None:
                for pt in _plan_counts(group, coll):
                    stack.enter_context(pt)
            if item == "advance":
                st, secs = on_card(lambda st=st: driver.advance(st, {}), dev)
            elif item[0] == "move":
                st, secs = on_card(lambda st=st: m.move_window(
                    tuple(item[1]), st), dev)
            else:
                p = StepParams(*item[1])
                (u1, info), secs = on_card(lambda: m.system.step(
                    st.u, st.u, st.u_old1, {}, p), dev)
                st = dataclasses.replace(st, u=u1)
        whole = m.system.gather_state(st.u)
        rows.append({"item": item if isinstance(item, str) else item[0],
                     "col_norms": torch.linalg.vector_norm(
                         whole, dim=0).tolist(),
                     "t": st.t, "dt": st.dt, "n_accepted": st.n_accepted,
                     "n_rejected": st.n_rejected, "s": secs,
                     "newton_iterations": counts.get("newton_iteration", 0),
                     "bicgstab_iterations": counts.get("bicgstab", 0),
                     "gmres_iterations": counts.get("gmres", 0),
                     "k1_launches": sum(k1.LAUNCHES.values()),
                     "collectives": dict(coll)})
    return {"rank": group.rank if group is not None else 0,
            "card": card_of(dev), "rows": rows,
            "u": whole.cpu() if group is None or group.rank == 0 else None}


def _perturbed(system, st, eps: float, seed: int):
    """`st` with u scaled by (1 + eps * noise): standard normal noise over
    the whole grid from `seed`, each rank keeping its rows."""
    whole = system.gather_state(st.u)
    noise = np.random.default_rng(seed).standard_normal(tuple(whole.shape))
    u = whole * (1.0 + eps * torch.as_tensor(noise, device=whole.device,
                                             dtype=whole.dtype))
    return dataclasses.replace(st, u=system.place_state(u))


def krylov_spread(group, spec: dict) -> list:
    """The port's own spread of a march's counts on one card: `spec`'s
    march (`slab_march` without a group, on spec `device`, or on this
    rank's card) again for each (eps, seed) of spec["perturbations"],
    the state perturbed (`_perturbed`) before plan item spec["before"].
    Per run: eps, seed and per item the Krylov iterations (BiCGStab and
    GMRES summed), the Newton iterations and the accepted count. With a
    group each rank adds 1000 times its rank to the seeds (its own noise)."""
    dev = spec.get("device", group.device if group is not None else None)
    shift = 1000 * group.rank if group is not None else 0
    out = []
    for eps, seed in spec["perturbations"]:
        seed += shift
        r = slab_march(None, {**spec, "device": str(dev),
                              "perturb": (eps, seed, spec["before"])})
        out.append({"eps": eps, "seed": seed,
                    "krylov": [row["bicgstab_iterations"]
                               + row["gmres_iterations"]
                               for row in r["rows"]],
                    "newton": [row["newton_iterations"]
                               for row in r["rows"]],
                    "n_accepted": [row["n_accepted"] for row in r["rows"]]})
    return out


def slab_march_one_rank(group, spec: dict) -> dict:
    """`slab_march` on z-slabs over a one-rank group on this rank's card
    (spec `device` without a group): the slab code with every collective
    the identity, which must march as one card does, bit for bit."""
    from .ranks import one_rank

    dev = group.device if group is not None else torch.device(
        spec["device"])
    with one_rank(dev) as g1:
        return slab_march(g1, spec)


def shard(group, spec: dict) -> dict:
    """The round-1 sharded system (`CoupledSystem.shard`) of a streamer
    model (`slab_model`'s spec, without the structured assembly) at
    spec `u` (whole-grid numpy state, float64): the residual at u, the
    node blocks at delta = 0 and one step at spec `params`, all whole (the
    same on every rank)."""
    from ..model.system import StepParams
    from ..models.streamer import StreamerConfig, StreamerModel

    dev = group.device
    m = StreamerModel(StreamerConfig(**spec.get("cfg", {})), device=dev)
    m.system.shard(group)
    u = torch.as_tensor(spec["u"], device=dev)
    p = StepParams(*spec["params"])
    F = m.system.residual(u, u, u, p)
    B = m.system.operators(u, u, p).jacobian_blocks(torch.zeros_like(u))
    u1, info = m.system.step(u, u, u, {}, p)
    return {"rank": group.rank, "F": F.cpu(), "B": B.cpu(), "u": u1.cpu(),
            "converged": bool(info.converged), "iters": int(info.iters),
            "launches": [b.scatter_idx is not None
                         for b, _ in m.system._shard[1]]}


def on_one_rank(group, spec: dict):
    """`spec["worker"]` with `spec["spec"]` on rank `spec["rank"]` alone, as
    one card without the group (a one-card reference on that rank's card);
    None on the other ranks."""
    if group.rank != spec["rank"]:
        return None
    return globals()[spec["worker"]](None, {**spec["spec"],
                                            "device": str(group.device)})


def slab_units(group, spec: dict) -> dict:
    """The slab pieces of a seeded grid (spec: n_i, n_j, levels, seed) on
    this rank's slab, each beside the whole-grid operation's own rows: the
    state's halo fill, the 9-point stencil matvec with halo rows, the
    z-line (PCR) solve of a gathered right-hand side, the restriction and
    the prolongation along z."""
    from ..fem.interpolation import prolong_axis, restrict_axis
    from ..solvers.linesmoother import tridiag_solve_pcr
    from ..solvers.stencil import stencil_matvec
    from ..solvers.structured_mg import StructuredPoissonMG
    from .slabs import SlabPoissonMG, Slabs

    dev = group.device
    rng = np.random.default_rng(spec.get("seed", 0))
    n_i, n_j, L = spec["n_i"], spec["n_j"], spec["levels"]
    xs = np.cumsum(rng.uniform(0.5, 1.5, n_i))
    zs = np.cumsum(rng.uniform(0.5, 1.5, n_j))
    mask = np.zeros((n_i, n_j), bool)
    mask[:, 0] = mask[:, -1] = True
    mg = StructuredPoissonMG(xs, zs, mask, L, dtype=torch.float64,
                             device=dev)
    sl = Slabs(group, n_i, n_j, L)
    smg = SlabPoissonMG(mg, sl)
    lo, hi = sl.lo, sl.hi
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    u = put(rng.standard_normal((n_j * n_i, 3)))
    X = put(rng.standard_normal((n_i, n_j)))
    n_c = mg._shapes[1][1]
    Uc = put(rng.standard_normal((n_i, n_c)))
    clo, chi = sl.layout.rows(group.rank, 1)
    S = mg.S[0]
    pairs = {
        "fill": (sl.fill(sl.own(u)), u[sl.a * n_i:sl.b * n_i]),
        "stencil": (stencil_matvec(S[..., lo:hi], sl.halo(
            X[:, lo:hi], dim=-1, zeros=True), halo=True),
            stencil_matvec(S, X)[:, lo:hi]),
        "pcr": (smg._smooth_full(0, X[:, lo:hi]),
                tridiag_solve_pcr(S[1, 0], S[1, 1], S[1, 2], X)),
        "restrict": (smg._restrict_z(0, X[:, lo:hi]),
                     restrict_axis(X, mg.wz[0])[:, clo:chi]),
        "prolong": (smg._prolong_z(0, Uc[:, clo:chi]),
                    prolong_axis(Uc, mg.wz[0])[:, lo:hi])}
    return {"rank": group.rank, "rows": (lo, hi),
            "equal": {k: bool(torch.equal(a, b))
                      for k, (a, b) in pairs.items()}}
