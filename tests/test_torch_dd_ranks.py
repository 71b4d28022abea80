"""The domain decomposition and the batched sweep on R ranks (gloo
processes on the CPU, one per card on the GPU), against one rank and
against the JAX package:

- the streamer (8 x 8) and the extended scheme (18 species, 8 x 8), 4
  parts on R = 2 ranks: the float64 residual and the node blocks at the
  initial state equal, bit for bit, those of one rank (a one-rank group
  in this process) and of the stacked system without a group; one step
  equal in its Newton and BiCGStab counts to the one-rank step, and
  within the tolerances that `tests/test_torch_dd.py` holds (rtol 1e-6,
  atol 1e-10) of the one-rank step and of the JAX DD's on 4 virtual
  devices (with its Newton count); the step and the residual each
  refused by the control that drops the rows the reverse exchange
  receives from the other rank;
- `BatchedSweep`, B = 4 members of the 10 x 14 streamer on R = 2 ranks
  from the JAX package's initial states, 3 attempts: every rank holds the
  whole SweepState; per member the counts, t and dt equal to one
  process's sweep, the states within 1e-12 of each column's max (the
  members' reductions sum in another order over half the batch), and
  held to the JAX sweep as `tests/test_torch_sweep.py` holds the
  one-process sweep (counts equal, t and dt 1e-12, max_error 1e-12, the
  states 1e-13 of each column's max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import fedm_tpu  # noqa: F401
from fedm_tpu.model.system import StepParams as JParams
from fedm_tpu.models.argon_synth import generate_argon_n_input as jgen
from fedm_tpu.models.generic import PlasmaConfig as JPlasmaConfig
from fedm_tpu.models.generic import PlasmaModel as JPlasma
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.parallel import BatchedSweep as JaxSweep
from fedm_tpu_torch.convert import sweep_state_from_arrays
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.parallel import BatchedSweep, rank_checks, ranks

LAUNCH_S = 300
N_PARTS, N_RANKS = 4, 2
STEP_RTOL, STEP_ATOL = 1e-6, 1e-10
AMPS = [2e18, 5e18, 1e19, 2e19]
N_ATTEMPTS = 3
FIELDS = ("u", "u_old", "u_old1", "t", "dt", "dt_old", "max_error",
          "n_accepted", "n_rejected")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("argon_n")
    return base, jgen(base, n_excited=13).name


def _specs(tree):
    base, name = tree
    common = dict(n_parts=N_PARTS, step=True, control=True)
    return {"streamer": dict(model="streamer", cfg=dict(nx=8, ny=8),
                             **common),
            "extended": dict(model="extended", tree=str(base),
                             tree_name=name,
                             argv=["--nx", "8", "--ny", "8"], **common)}


@pytest.fixture(scope="module", params=["streamer", "extended"])
def runs(request, tree):
    """(kind, the R = 2 ranks' results, the one-rank result, the stacked
    residual and blocks without a group)."""
    spec = _specs(tree)[request.param]
    two = ranks.launch(rank_checks.dd, N_RANKS, "cpu", (spec,),
                       timeout=LAUNCH_S)
    with ranks.one_rank("cpu") as g:
        one = rank_checks.dd(g, dict(spec, control=False))
    model = rank_checks._model(spec, "cpu")
    d = model.distribute(["cpu"] * N_PARTS)
    s = model.initial_state()
    aux = model._update_aux(s.u) if rank_checks.spec_is_generic(model) else {}
    from fedm_tpu_torch.model.system import StepParams

    p = StepParams(s.t + s.dt, s.dt, s.dt_old)
    stacked = (d.residual(s.u, s.u, s.u_old1, p, aux=aux),
               d.operators(s.u, s.u_old1, p, aux=aux).jacobian_blocks(
                   torch.zeros_like(s.u)))
    return request.param, two, one, stacked


def _rows(two, key):
    assert [o["row0"] for o in two] == [0, two[0]["n_rows"]]
    return torch.cat([o[key] for o in two])


def test_residual_and_blocks_bit_for_bit(runs):
    _, two, one, (F, B) = runs
    assert torch.equal(one["F"], F) and torch.equal(one["B"], B)
    assert torch.equal(_rows(two, "F"), one["F"])
    assert torch.equal(_rows(two, "B"), one["B"])
    assert torch.equal(_rows(two, "u0"), one["u0"])
    assert all(o["shifts"] == one["shifts"] for o in two)


def _close(u, ref):
    return bool((np.abs(u - ref) <= STEP_ATOL + STEP_RTOL
                 * np.abs(ref)).all())


def _jax_dd_step(jm, aux_of=None):
    """The JAX DD's step on 4 virtual devices from its initial state (the
    port's layout is the JAX package's: `tests/test_torch_dd.py`)."""
    jd = jm.distribute(Mesh(np.array(jax.devices()[:N_PARTS]), ("space",)))
    s = jm.initial_state()
    p = JParams(*(jnp.asarray(x) for x in (s.t + s.dt, s.dt, s.dt_old)))
    aux = {} if aux_of is None else aux_of(s.u)
    u, info = jd.step(s.u, s.u, s.u_old1, aux, p)
    assert bool(info.converged)
    return np.asarray(u), int(info.iters)


@pytest.fixture(scope="module")
def jax_dd_step_streamer():
    return _jax_dd_step(JaxModel(JaxConfig(nx=8, ny=8)))


@pytest.fixture(scope="module")
def jax_dd_step_extended(tree):
    base, name = tree
    jm = JPlasma(JPlasmaConfig(model=name, file_input=base, nx=8, ny=8,
                               mg_levels=0, quad_degree=2))
    return _jax_dd_step(jm, lambda u: jm._update_aux_jit(u))


def test_one_step_on_two_ranks(runs, request):
    kind, two, one, _ = runs
    steps = [o["step"] for o in two]
    assert all(st["converged"] for st in steps)
    for key in ("newton_iterations", "bicgstab_iterations",
                "gmres_iterations"):
        assert steps[0][key] == steps[1][key] == one["step"][key]
    u = _rows([dict(o, u=o["step"]["u"]) for o in two], "u").numpy()
    assert _close(u, one["step"]["u"].numpy())
    ref, iters = request.getfixturevalue(f"jax_dd_step_{kind}")
    assert steps[0]["iters"] == iters
    assert _close(u, ref)
    # the control: the rows from the other rank dropped in the reverse
    # exchange
    F = one["F"].numpy()
    cF = _rows([dict(o, c=o["control_F"]) for o in two], "c").numpy()
    assert not (np.abs(cF - F) <= 1e-12 * np.abs(F).max() + 1e-10
                * np.abs(F)).all()
    cu = _rows([dict(o, c=o["control_step"]["u"]) for o in two],
               "c").numpy()
    assert not _close(cu, one["step"]["u"].numpy())


@pytest.fixture(scope="module")
def sweeps():
    """The JAX sweep (start arrays and per-attempt records), the port's
    one-process sweep and its sweep on 2 ranks, from the same start."""
    cfg = JaxConfig(nx=10, ny=14)
    jm = JaxModel(cfg)
    states = [JaxModel(JaxConfig(nx=10, ny=14, seed_amplitude=a))
              .initial_state() for a in AMPS]
    sw = JaxSweep(jm.system, monitor_idx=1, ttol=cfg.ttol,
                  dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    st = sw.from_states(states)
    start = {k: np.array(getattr(st, k)) for k in FIELDS}
    jrec = []
    for _ in range(N_ATTEMPTS):
        st = sw.attempt(st, {})
        jrec.append({k: np.asarray(getattr(st, k)) for k in FIELDS})
    spec = dict(cfg=dict(nx=10, ny=14), amps=AMPS, attempts=N_ATTEMPTS,
                start=start)
    two = ranks.launch(rank_checks.sweep, N_RANKS, "cpu", (spec,),
                       timeout=LAUNCH_S)
    pcfg = StreamerConfig(nx=10, ny=14)
    model = StreamerModel(pcfg, device="cpu")
    psw = BatchedSweep(model.system, monitor_idx=1, ttol=pcfg.ttol,
                       dt_min=pcfg.dt_min, dt_max=pcfg.dt_max)
    pst = sweep_state_from_arrays(start, device="cpu")
    one = []
    for _ in range(N_ATTEMPTS):
        pst = psw.attempt(pst, {})
        one.append((rank_checks.record(pst), pst.u.clone()))
    return jrec, one, two


def _state_gap(u, ref):
    scale = np.abs(ref).max(axis=1, keepdims=True)
    return np.max(np.abs(u - ref) / scale, axis=(1, 2))


def test_sweep_on_two_ranks_is_the_one_process_sweep(sweeps):
    _, one, two = sweeps
    assert [o["members"] for o in two] == [slice(0, 2), slice(2, 4)]
    for i, (rec, _) in enumerate(one):
        for o in two:
            got = o["records"][i]
            assert got == two[0]["records"][i]   # every rank: all of it
            for k in ("n_accepted", "n_rejected", "t", "dt"):
                assert got[k] == rec[k], k
            np.testing.assert_allclose(got["max_error"], rec["max_error"],
                                       rtol=1e-12)
    u1 = one[-1][1].numpy()
    for o in two:
        assert (_state_gap(o["u"].numpy(), u1) <= 1e-12).all()
    # some members were rejected along the way: the verdicts crossed ranks
    assert sum(one[-1][0]["n_rejected"]) > 0


def test_sweep_on_two_ranks_holds_to_the_jax_sweep(sweeps):
    jrec, _, two = sweeps
    for i, ref in enumerate(jrec):
        got = two[0]["records"][i]
        assert got["n_accepted"] == ref["n_accepted"].tolist()
        assert got["n_rejected"] == ref["n_rejected"].tolist()
        for k in ("t", "dt"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12)
        np.testing.assert_allclose(got["max_error"], ref["max_error"],
                                   rtol=1e-12)
    assert (_state_gap(two[0]["u"].numpy(), jrec[-1]["u"]) <= 1e-13).all()
