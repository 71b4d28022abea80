"""Where a z-slab rank's operators leave one card's bits.

A rank of the z-slab layout (`CoupledSystem.use_gspmd`) runs the one-card
code on its own rows and cells; what it computes should equal one card's
rows bit for bit, except where an operation's rounding depends on how
many rows it is given (cuBLAS picks a batched GEMM's kernel by the batch
count). This probe separates the two causes. It runs the R ranks as
threads of one process on one device (`ThreadGroup`: the collectives of
`ranks.Group` through shared memory), so every rank computes at its own
counts on the same card as the one-card run, and no value crosses a
card. Per case it reports:

1. each operator of `rank_checks.ops_record` (the residual in the compute
   type and in float64, J v, the node blocks, one V-cycle, one z-line
   solve, the whole preconditioner M): bit for bit, and else the gap of
   each column (equation, block entry) over that column's largest entry;
2. where the residual or the float64 defect differs, each aten op of each
   batch's element kernel in order, the rank's cells against the same
   cells of one card's run: the first op whose output differs names the
   term, and it is count rounding where it is a batched GEMM whose inputs
   are equal and whose shapes differ only in the batch count;
3. for M, its parts on one card's own data at each rank's rows: the
   block inversion, the block product (`block_apply`'s einsum) and the
   Poisson row;
4. `exempt`: per operator, whether its difference is count rounding
   alone (`exemptions`), which `chip_smoke.py` phase 12 and the two-card
   GPU test then hold per column (`judge`);
5. controls: one card's result rounded to bfloat16 (an 8-bit
   significand), and the float32 residual's gap to the float64 defect
   (its own rounding).

    python -m fedm_tpu_torch.parallel.slab_probe           # on the card
    python -m fedm_tpu_torch.parallel.slab_probe --device cpu --case mini

`--case restart`: bench.py's restart from its checkpoint on R = 4;
`--case mini`: the miniature production model of `tests/test_torch_gpu.py`
on R = 2. Prints one JSON object; `--save PATH` also keeps the operators'
tensors (`torch.save`).

A model spec's `poisson` (`rank_checks.slab_model`'s) puts another
Poisson-row solve in place of the model's own. `poisson_row` holds one
application of a built system's Poisson-row solve on emulated ranks
against its own, bit for bit.

With `--spread restart|window` it measures instead the port's own spread
of a march's Newton and Krylov counts on one card
(`rank_checks.krylov_spread`): `chip_smoke.py` phase 12's march (the
restart's 4 advances, or the fresh window's forced move and 2 advances)
again from the state scaled by (1 + eps * noise) before the first
advance, for each `--eps` and `--seed`; and, with `--one-rank`, the
unperturbed march on one card and on one slab of a one-rank group, which
must agree bit for bit. One JSON line per run.

    python -m fedm_tpu_torch.parallel.slab_probe --spread window \
        --eps 1e-12 1e-11 1e-10 --seed 0
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import threading
import time

import numpy as np
import torch

from ..devtime import card_of
from .rank_probe import _OpLog


class _Hub:
    """What the threads of one emulated group share: a barrier, a mailbox
    and the lock that lets one rank run at a time (forward-mode AD keeps
    one dual level per process, so two ranks' J v must not overlap)."""

    def __init__(self, size: int, timeout_s: float):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout_s)
        self.box = {}
        self.turn = threading.Lock()

    def wait(self):
        """The barrier, with the turn given up while waiting."""
        self.turn.release()
        try:
            self.barrier.wait()
        finally:
            self.turn.acquire()


class ThreadGroup:
    """`ranks.Group`'s collectives for R ranks that are threads of one
    process on one device. Each call meets the other ranks at the hub's
    barrier; sums run in rank order. One rank runs at a time: a rank
    gives up its turn only at a barrier."""

    def __init__(self, hub: _Hub, rank: int, device):
        self.hub, self.rank, self.size = hub, int(rank), hub.size
        self.device = torch.device(device)

    def _meet(self, key, value):
        """Every rank's `value` posted under `key`, in rank order."""
        h = self.hub
        h.box[(key, self.rank)] = value
        h.wait()
        vals = [h.box[(key, q)] for q in range(self.size)]
        h.wait()
        h.box.pop((key, self.rank))
        return vals

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        vals = self._meet("reduce", t.detach().clone())
        out = vals[0].clone()
        for v in vals[1:]:
            out = (out + v if op == "sum" else torch.maximum(out, v)
                   if op == "max" else torch.minimum(out, v))
        return out

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._meet("gather", t.detach().clone()))

    def exchange(self, sends, recvs) -> None:
        posted = {peer: t.detach().clone() for peer, t in sends}
        vals = self._meet("exchange", posted)
        for peer, buf in recvs:
            buf.copy_(vals[peer][self.rank])

    def check_same(self, value: int, what: str) -> None:
        vals = self._meet("same", int(value))
        if any(v != value for v in vals):
            raise RuntimeError(f"{what} differs between the ranks "
                               f"(rank {self.rank}: {value})")


def emulate(fn, n_ranks: int, device, args: tuple = (),
            timeout_s: float = 300.0) -> list:
    """fn(group, *args) on `n_ranks` threads of this process, each with a
    `ThreadGroup` on `device`; their results in rank order. A rank that
    raises breaks the others' barrier, and the first error is raised."""
    hub = _Hub(n_ranks, timeout_s)
    out, errs = [None] * n_ranks, [None] * n_ranks

    def run(k):
        hub.turn.acquire()
        try:
            out[k] = fn(ThreadGroup(hub, k, device), *args)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errs[k] = e
            hub.barrier.abort()
        finally:
            hub.turn.release()

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = [e for e in errs if e is not None
             and not isinstance(e, threading.BrokenBarrierError)]
    if first or any(errs):
        raise first[0] if first else next(e for e in errs if e)
    return out


def column_gaps(got: torch.Tensor, ref: torch.Tensor) -> list:
    """Per column (every axis after the first flattened): max |got - ref|
    over that column's largest |ref| (0 where both are 0)."""
    g = got.double().reshape(got.shape[0], -1)
    r = ref.double().reshape(ref.shape[0], -1)
    err = (g - r).abs().amax(0)
    scale = r.abs().amax(0)
    return torch.where(scale > 0, err / scale,
                       torch.where(err > 0, torch.inf, 0.0)).tolist()


# Where an operator's difference from one card is shown to be count
# rounding alone (`probe`'s `exempt`), the ranks' result is held per column
# (equation, block entry) to one card's by `judge`: the float32 residual
# no further from one card's float64 defect than ANCHOR_FACTOR times one
# card's own float32 residual is; the float64 defect within ANCHOR_FACTOR
# times that own float32 gap scaled by the two types' unit roundoffs (a
# sum's rounding grows with its terms, which the float32 gap measures: the
# Poisson row's is several times the row's largest entry); without those,
# float64 to phase 8's tolerance (1e-10 relative, 1e-12 of the column's
# largest entry) and float32 within F32_COLUMN_GAP of the column's largest
# entry. PERF.md section 6 has the gaps of sound runs and of the controls
# that set these.
ANCHOR_FACTOR = 2.0
F64_RTOL, F64_COLUMN_ATOL = 1e-10, 1e-12
F32_COLUMN_GAP = 1e-3
_U32 = torch.finfo(torch.float32).eps / 2
_U64 = torch.finfo(torch.float64).eps / 2


def _columns(x: torch.Tensor) -> torch.Tensor:
    return x.double().reshape(x.shape[0], -1)


def judge(got: torch.Tensor, ref: torch.Tensor,
          anchor: torch.Tensor = None) -> dict:
    """The per-column hold above of `got` (the ranks' rows) to `ref` (one
    card's); `anchor`: for the float32 residual one card's float64 defect,
    for the float64 defect one card's float32 residual. {"ok", "worst":
    the largest column's gap over its bound, "by_column"}."""
    g, r = _columns(got), _columns(ref)
    col = r.abs().amax(0)
    if anchor is not None and ref.dtype == torch.float64:
        own = (_columns(anchor) - r).abs().amax(0) * (_U64 / _U32)
        worst = (g - r).abs().amax(0) / (
            ANCHOR_FACTOR * torch.maximum(own, _U64 * col))
    elif anchor is not None:
        a = _columns(anchor)
        own = (r - a).abs().amax(0)
        worst = (g - a).abs().amax(0) / (
            ANCHOR_FACTOR * torch.maximum(own, _U32 * a.abs().amax(0)))
    elif ref.dtype == torch.float64:
        lim = F64_RTOL * r.abs() + F64_COLUMN_ATOL * col
        worst = ((g - r).abs() / lim).nan_to_num(0.0, torch.inf,
                                                 torch.inf).amax(0)
    else:
        worst = (g - r).abs().amax(0) / (F32_COLUMN_GAP * col)
    worst = worst.nan_to_num(0.0, torch.inf, torch.inf)
    return {"ok": bool((worst <= 1.0).all()), "worst": float(worst.max()),
            "by_column": worst.tolist()}


def anchor_of(k: str, one: dict):
    """`judge`'s anchor for operator `k` of one card's `ops_record`."""
    return {"F": one.get("F64"), "F64": one.get("F")}.get(k)


def _rank_ops(group, spec: dict):
    """On one emulated rank (or one card without a group): `ops_record`
    of the case's model (spec `seed`), plus what the op-by-op probe
    replays, in the compute type and in float64: the batches, their
    contexts and the halo-filled delta."""
    from ..model.system import StepParams
    from .rank_checks import _slab_state, ops_record, slab_model

    dev = torch.device(spec["device"]) if group is None else group.device
    m = slab_model(spec, dev)
    st = _slab_state(spec, m, dev)
    rec = ops_record(m, st, group, spec)
    sysm = m.system
    place = sysm.place_state
    u, u_old = place(st.u), place(st.u_old)
    p = StepParams(st.t + st.dt, st.dt, st.dt_old)
    rec["_replay"] = {}
    for key, dt in (("F", None), ("F64", torch.float64)):
        ops = sysm.operators(u, u_old, p, dt)
        rec["_replay"][key] = {
            "batches": ops.batches, "ctxs": ops.ctxs,
            "d_in": ops._in((u - u_old).to(ops.dtype)),
            "cells": [getattr(b, "cells", None) for b, _ in ops.batches]}
    return rec


GEMMS = ("aten.bmm.default", "aten.mm.default", "aten.baddbmm.default",
         "aten.addmm.default")


class _OpIO(_OpLog):
    """`_OpLog`, with the inputs of every batched GEMM cloned too."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if str(func) in GEMMS:
            self.log[-1] += ([a.detach().clone() for a in args
                              if isinstance(a, torch.Tensor)],)
        return out


def _kernel_log(rep: dict, bi: int) -> list:
    (batch, kernel), ctx = rep["batches"][bi], rep["ctxs"][bi]
    log = []
    with _OpIO(log):
        kernel(batch, batch.gather(rep["d_in"]), ctx)
    return log


def _on_cells(a: torch.Tensor, b: torch.Tensor, cells):
    """`a` (one card's) at the rank's cells where `b` (the rank's) holds
    only those, `a` itself where the shapes agree, else None."""
    if a.dim() > 0 and b.dim() > 0 and (
            a.shape[1:] == b.shape[1:] and b.shape[0] == len(cells)
            and a.shape[0] != b.shape[0]):
        return a[cells.to(a.device)]
    return a if a.shape == b.shape else None


def _first_differing_op(log_one: list, log_rank: list, cells) -> dict:
    """The first op (in order, names matching) whose output on the rank's
    cells differs from one card's on the same cells. `count_rounding`: it
    is a batched GEMM whose inputs there are equal, bit for bit, and whose
    shapes differ only in the batch count (cuBLAS's choice of kernel)."""
    cells = torch.as_tensor(np.asarray(cells))
    n = 0
    for i, (x, y) in enumerate(zip(log_one, log_rank)):
        (f, sf, of), (g, sg, og) = x[:3], y[:3]
        if f != g:
            return {"diverged_at": i, "one_card_op": f, "rank_op": g,
                    "count_rounding": False}
        for a, b in zip(of, og):
            a = _on_cells(a, b, cells)
            if a is None or a.dim() == 0:
                continue
            n += 1
            if torch.equal(a, b):
                continue
            d = (a.double() - b.double()).abs()
            ins = [(_on_cells(p, q, cells), q) for p, q in
                   zip(x[3], y[3])] if len(x) > 3 else []
            same_in = bool(ins) and all(p is not None and torch.equal(p, q)
                                        for p, q in ins)
            batch_only = all(tuple(u[1:]) == tuple(v[1:])
                             for u, v in zip(sf, sg))
            return {"first_differing_op": i, "op": f,
                    "input_shapes_one_card": sf, "input_shapes_rank": sg,
                    "inputs_equal": same_in,
                    "count_rounding": f in GEMMS and same_in and batch_only,
                    "max_abs_diff": float(d.max()),
                    "max_abs": float(a.double().abs().max()),
                    "n_diff": int((a != b).sum()), "outputs_compared": n,
                    "previous_ops": [z[0] for z in
                                     log_one[max(0, i - 6):i]]}
    return {"ops": len(log_one), "outputs_compared": n, "all_equal": True,
            "count_rounding": False}


OPS = ("F", "F64", "Jv", "B", "V", "zline", "M")


def _kernels(one: dict, res: list, key: str) -> list:
    """Per rank, per element batch it holds: the first op of the batch's
    kernel (`key` "F": the compute type, "F64") that differs on the
    rank's cells from one card's."""
    rep1 = one["_replay"][key]
    out = []
    for r in res:
        rep = r["_replay"][key]
        by_batch = []
        for bi, cells in enumerate(rep["cells"]):
            if cells is None:
                continue
            # the one-card batch that holds these elements: the cell batch
            # first, then the facet batch of the same element shape (a rank
            # without a batch's facets holds no view of it)
            j = 0 if bi == 0 else next(
                (q for q in range(1, len(rep1["batches"]))
                 if rep1["batches"][q][0].dofs.shape[1]
                 == rep["batches"][bi][0].dofs.shape[1]), None)
            if j is not None:
                by_batch.append({"batch": bi, "n": int(len(cells)),
                                 "ops": _first_differing_op(
                                     _kernel_log(rep1, j),
                                     _kernel_log(rep, bi), cells)})
        out.append(by_batch)
    return out


def _rounds_by_count(kernels: list) -> bool:
    """Every batch of every rank either equal throughout, or first off at
    a GEMM's count rounding, and at least one so."""
    firsts = [b["ops"] for r in kernels for b in r]
    return (all(f.get("all_equal") or f["count_rounding"] for f in firsts)
            and any(f["count_rounding"] for f in firsts))


def exemptions(rounds: dict, blocks_bitwise: bool, parts: list,
               poisson_row_equal: bool) -> dict:
    """Per operator, whether its difference from one card is count
    rounding alone: `rounds` {"F", "F64": `_rounds_by_count` of that
    kernel's first differing ops}; the residual and the float64 defect by
    their own kernels, J v, the blocks and the z-line solve by the compute
    type's; M by that, or by `block_apply` (`parts`: per rank whether the
    block inversion and the block product equal one card's at its rows)
    where the blocks are bit for bit; M's Poisson row must be bit for bit,
    and the Poisson-row solve V is never exempt (every slab solve is held
    bit for bit)."""
    cells = rounds.get("F", False)
    by_blocks = (blocks_bitwise
                 and all(p["invert_blocks_equal"] for p in parts)
                 and not all(p["block_apply_equal"] for p in parts))
    return {"F": cells, "F64": rounds.get("F64", False), "Jv": cells,
            "B": cells, "V": False, "zline": cells,
            "M": poisson_row_equal and (cells or by_blocks)}


def probe(spec: dict, n_ranks: int, device, keep: bool = False) -> dict:
    """The module docstring's report for one model spec
    (`rank_checks.slab_model`'s, with `ckpt` for a checkpoint state, and
    `seed`, `ops_record`'s) on `n_ranks` emulated ranks, and `exempt`:
    per operator, whether its difference from one card is shown to be
    count rounding alone (the residual, the float64 defect: their own
    kernels; J v, the blocks, the z-line solve: the compute type's
    kernel; M: that, or the blocks and the Poisson row bit for bit and
    `block_apply` off at equal inputs). `keep`: also the operators' tensors
    (`_one`, one card's; `_ranks`, each emulated rank's)."""
    from ..solvers.precond import block_apply, invert_blocks

    t0 = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    spec = {**spec, "device": str(dev)}
    one = _rank_ops(None, spec)
    res = emulate(lambda g: _rank_ops(g, spec), n_ranks, dev)
    out = {"device": str(dev), "card": card_of(dev), "ranks": n_ranks,
           "rows": [r["rows"] for r in res],
           "cells": [int(r["grads_shape"][0]) for r in res],
           "one_card_cells": int(one["grads_shape"][0]), "ops": {}}
    for k in OPS:
        got = torch.cat([r[k] for r in res])
        ref = one[k]
        rec = {"dtype": str(ref.dtype)[6:], "bitwise": torch.equal(got, ref)}
        if not rec["bitwise"]:
            rec["column_gaps"] = column_gaps(got, ref)
        rec["bf16_control_column_gaps"] = column_gaps(
            ref.to(torch.bfloat16), ref)
        out["ops"][k] = rec
    out["ops"]["F"]["f64_gap_column_gaps"] = column_gaps(one["F"],
                                                         one["F64"])
    # 2: the element kernels, op by op, on the rank's cells (where the
    # operator differs)
    out["kernels"] = {key: _kernels(one, res, key) for key in ("F", "F64")
                      if not out["ops"][key]["bitwise"]}
    rounds = {key: _rounds_by_count(v) for key, v in out["kernels"].items()}
    # 3: M's parts at each rank's rows, on one card's blocks
    n = one["B"].shape[0]
    rng = np.random.default_rng(spec.get("seed", 0))
    rng.standard_normal((n, 3))
    rng.standard_normal(n)
    r3 = torch.as_tensor(rng.standard_normal((n, 3)), device=dev).to(
        one["B"].dtype)
    B = one["B"].to(dev)
    inv = invert_blocks(B)
    y = block_apply(inv, r3)
    n_i = n // res[-1]["rows"][1]
    parts = []
    for r in res:
        sl = slice(r["rows"][0] * n_i, r["rows"][1] * n_i)
        y_r = block_apply(inv[sl], r3[sl])
        parts.append({"rows": r["rows"], "n": sl.stop - sl.start,
                      "invert_blocks_equal": torch.equal(
                          invert_blocks(B[sl]), inv[sl]),
                      "block_apply_equal": torch.equal(y_r, y[sl]),
                      "block_apply_max_abs_diff": float(
                          (y_r - y[sl]).abs().max())})
    got_M = torch.cat([r["M"] for r in res])
    out["M_parts"] = {"by_rank": parts,
                      "poisson_row_equal": torch.equal(got_M[:, 2],
                                                       one["M"][:, 2])}
    out["exempt"] = exemptions(rounds, out["ops"]["B"]["bitwise"], parts,
                               out["M_parts"]["poisson_row_equal"])
    out["s"] = time.perf_counter() - t0
    if keep:
        keys = OPS + ("control_F", "rows", "card")
        out["_one"] = {k: one[k] for k in keys if k in one}
        out["_ranks"] = [{k: r[k] for k in keys if k in r} for r in res]
    return out


def _slab_solve(group, system, r: torch.Tensor) -> torch.Tensor:
    """On one emulated rank: a shallow copy of `system` put on z-slabs
    (`use_gspmd`; `system` itself stays on one card), its Poisson-row
    solve of this rank's rows of `r`."""
    s = copy.copy(system)
    s.use_gspmd(group)
    return s._ell[1](s.place_state(r))


def poisson_row(system, r: torch.Tensor, n_ranks: int) -> dict:
    """One application of `system`'s Poisson-row solve to the whole-grid
    `r` on `n_ranks` ranks emulated as threads on its device, against the
    system's own on one card: "bitwise", and where not, each column's
    gap."""
    t0 = time.perf_counter()
    ref = system._ell[1](r)
    got = torch.cat(emulate(lambda g: _slab_solve(g, system, r), n_ranks,
                            r.device))
    out = {"ranks": n_ranks, "solver": type(system._ell[1].__self__).__name__,
           "dtype": str(ref.dtype)[6:], "bitwise": torch.equal(got, ref)}
    if not out["bitwise"]:
        out["column_gaps"] = column_gaps(got, ref)
    out["s"] = time.perf_counter() - t0
    return out


def case(name: str) -> tuple:
    """(model spec, ranks) of `--case`."""
    if name == "restart":
        from pathlib import Path

        from ..gspmd_identity import spec_for

        ckpt = (Path(__file__).resolve().parents[2] / "bench_assets"
                / "bagheri_dz1e-5_ckpt.npz")
        s = spec_for(ckpt, 1)
        return {k: s[k] for k in ("cfg", "newton", "float32", "ckpt")}, 4
    return ({"cfg": dict(z_corridor=(8.5e-3, 1e-2, 5e-5),
                         r_corridor=(2e-3, 2e-4), z_tail_cells=(12, 12),
                         mg_levels=3, density_floor=1e13,
                         poisson_precond="mg-zline"),
             "newton": dict(host_loop=True, hi_residual=True),
             "float32": True}, 2)


# chip_smoke.py's REF_WINDOW: the fresh window's corridor and its forced
# move (tools/port_reference_window.py)
WINDOW_CORRIDOR = (0.0091, 0.0106, 1e-05)
WINDOW_MOVED_TO = (0.009000000000000001, 0.0105, 1e-05)


def march_spec(name: str) -> tuple:
    """(march spec, index of the first advance) of `--spread`: the spec
    `chip_smoke.py` phase 12 marches."""
    if name == "restart":
        from pathlib import Path

        from ..gspmd_identity import spec_for

        return spec_for(Path(__file__).resolve().parents[2] / "bench_assets"
                        / "bagheri_dz1e-5_ckpt.npz", 4), 0
    return ({"bagheri_argv": ["--preset", "bagheri14", "--no-direct-rescue"],
             "corridor": WINDOW_CORRIDOR,
             "plan": [("move", WINDOW_MOVED_TO), "advance", "advance"],
             "driver": {"fail_dt_cap": 0.7, "predictor": 1.0}}, 1)


def spread(name: str, device, eps: list, seeds: list,
           one_rank: bool) -> None:
    """`--spread` (module docstring): one JSON line per run."""
    from .rank_checks import krylov_spread, slab_march, slab_march_one_rank

    spec, first = march_spec(name)
    spec = {**spec, "device": str(device)}
    if one_rank:
        runs = [slab_march(None, spec), slab_march_one_rank(None, spec)]
        print(json.dumps({"march": name, "one_rank": {
            "u_equal": torch.equal(runs[0]["u"], runs[1]["u"]),
            "rows_equal": [
                {k: v for k, v in a.items() if k not in ("s", "collectives")}
                == {k: v for k, v in b.items() if k not in ("s", "collectives")}
                for a, b in zip(runs[0]["rows"], runs[1]["rows"])],
            "krylov": [[r["bicgstab_iterations"] + r["gmres_iterations"]
                        for r in run["rows"]] for run in runs],
            "s": [[r["s"] for r in run["rows"]] for run in runs]}}),
            flush=True)
    for e in eps:
        for sd in seeds:
            rec = krylov_spread(None, {**spec, "before": first,
                                       "perturbations": [(e, sd)]})[0]
            print(json.dumps({"march": name, **rec}), flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--case", choices=["restart", "mini"], action="append",
                    help="repeatable; default both")
    ap.add_argument("--ranks", type=int, default=None,
                    help="emulated ranks (default: the case's)")
    ap.add_argument("--save", default=None,
                    help="also torch.save the report with the operators' "
                         "tensors (one card's, each rank's) of the last "
                         "case to this path")
    ap.add_argument("--spread", choices=["restart", "window"], default=None)
    ap.add_argument("--eps", type=float, nargs="*", default=[])
    ap.add_argument("--seed", type=int, nargs="*", default=[0])
    ap.add_argument("--one-rank", action="store_true")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device (pass --device cpu)")
    if a.spread is not None:
        spread(a.spread, a.device, a.eps, a.seed, a.one_rank)
        return {}
    out = {}
    for name in a.case or ["restart", "mini"]:
        spec, R = case(name)
        out[name] = probe(spec, a.ranks or R, a.device,
                          keep=a.save is not None)
    if a.save is not None:
        torch.save(out[name], a.save)
    print(json.dumps({k: {q: v for q, v in r.items()
                          if not q.startswith("_")}
                      for k, r in out.items()}, default=str))
    return out


if __name__ == "__main__":
    main()
