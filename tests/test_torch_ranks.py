"""The port's ranks (`fedm_tpu_torch.parallel.ranks`: one process per card,
here gloo processes on the CPU) against one process:

- the domain decomposition's halo fill and reduce with N = 6 parts on
  R = 2 and 3 ranks, on payloads seeded by numpy, equal bit for bit to the
  stacked `torch.roll` exchange of one process;
- `_dot`, `_norm` and `finite` on R = 2 ranks (each holding half the
  rows) against one process: norms within 1e-15 relative, dots within
  1e-14 of |a|.|b| (another summation order), a non-finite entry on one
  rank seen by every rank; `dot_b`, `norm_b` and `finite_b` of members
  split over the ranks as the sweep splits them, gathered: bit for bit one
  process's; over a one-rank group every value bit for bit what it is
  without a group;
- a distributed step on R = 2: the ranks' Newton and Krylov logs equal to
  each other;
- no hidden fallback: a rank that skips a collective fails the launch
  within its timeout, more ranks than CUDA devices raise, a part count
  the cards do not divide stops the entry points.

Every launch has a time limit, so a deadlock fails the test instead of
hanging the suite. The rank workers are `parallel.rank_checks`: the ranks
import neither JAX nor a test module.
"""

import time

import numpy as np
import pytest
import torch

from fedm_tpu_torch import dd_scale
from fedm_tpu_torch.examples import extended_scheme
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.parallel import rank_checks, ranks

LAUNCH_S = 180


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_halo_exchange_is_the_stacked_roll(n_ranks):
    spec = dict(cfg=dict(nx=8, ny=10), n_parts=6, seed=3)
    res = ranks.launch(rank_checks.halo, n_ranks, "cpu", (spec,),
                       timeout=LAUNCH_S)
    m = StreamerModel(StreamerConfig(**spec["cfg"]), device="cpu")
    d = m.distribute(["cpu"] * 6)
    assert len(d._shifts) > 1    # several ring shifts, some across ranks
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((d.n_dofs_dist, 3)))
    r = torch.as_tensor(rng.standard_normal((d.n_parts * d.n_ext, 3)))
    assert [o["rank"] for o in res] == list(range(n_ranks))
    assert torch.equal(torch.cat([o["fill"] for o in res]),
                       d._halo_fill(x))
    assert torch.equal(torch.cat([o["reduce"] for o in res]),
                       d._halo_reduce(r))


@pytest.fixture(scope="module")
def reductions():
    spec = dict(n=60, B=4, seed=4)
    two = ranks.launch(rank_checks.reductions, 2, "cpu", (spec,),
                       timeout=LAUNCH_S)

    with ranks.one_rank("cpu") as g:
        one_rank = rank_checks.reductions(g, spec)
    return two, one_rank, spec


def _one_process(spec):
    """The values without a group, from the same seeded vectors."""
    from fedm_tpu_torch.solvers.linear import _dot, _norm, dot_b, norm_b

    rng = np.random.default_rng(spec["seed"])
    n, B = spec["n"], spec["B"]
    scale = 10.0 ** rng.integers(-30, 30, size=(n, 1))
    a = rng.standard_normal((n, 3)) * scale
    b = rng.standard_normal((n, 3))
    ab = rng.standard_normal((B, n, 2)) * scale[None]
    bb = rng.standard_normal((B, n, 2))
    t = torch.as_tensor
    return {"dot": float(_dot(t(a), t(b))), "norm": float(_norm(t(a))),
            "dot_b": dot_b(t(ab), t(bb)).numpy(),
            "norm_b": norm_b(t(ab)).numpy(),
            "abs_dot": float(np.abs(a * b).sum())}


def test_reductions_over_two_ranks_are_one_process(reductions):
    two, _, spec = reductions
    ref = _one_process(spec)
    for out in two:   # every rank holds the same values
        assert out["dot"] == two[0]["dot"]
        np.testing.assert_array_equal(out["dot_b"], two[0]["dot_b"])
        assert abs(out["dot"] - ref["dot"]) <= 1e-14 * ref["abs_dot"]
        assert abs(out["norm"] - ref["norm"]) <= 1e-15 * ref["norm"]
        # a member's reductions never leave its rank
        np.testing.assert_array_equal(out["dot_b"], ref["dot_b"])
        np.testing.assert_array_equal(out["norm_b"], ref["norm_b"])
        # the NaN sits on the last rank: every rank sees it; the inf in
        # member 1 (rank 0's) is that member's alone
        assert out["finite"] == (True, False)
        np.testing.assert_array_equal(out["finite_b"],
                                      [True, False, True, True])


def test_reductions_over_one_rank_are_bitwise_no_group(reductions):
    _, one, spec = reductions
    ref = _one_process(spec)
    assert one["dot"] == ref["dot"] and one["norm"] == ref["norm"]
    np.testing.assert_array_equal(one["dot_b"], ref["dot_b"])
    np.testing.assert_array_equal(one["norm_b"], ref["norm_b"])


def test_one_rank_group_calls_no_backend():
    # no process group is initialised: a collective over one rank returns
    # its input, so the one-card path issues no collective at all
    assert not torch.distributed.is_initialized()
    g = ranks.Group(0, 1, "cpu")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((7, 3)))
    assert g.all_reduce(x, "max") is x and g.all_gather_rows(x) is x
    g.check_same(12345, "a value")


def test_newton_and_krylov_logs_are_the_same_on_every_rank():
    spec = dict(model="streamer", cfg=dict(nx=6, ny=8), n_parts=4,
                step=True)
    res = ranks.launch(rank_checks.dd, 2, "cpu", (spec,), timeout=LAUNCH_S)
    logs = [o["step"]["log"] for o in res]
    assert logs[0] == logs[1]
    kinds = {entry[0] for entry in logs[0]}
    assert {"newton_iteration", "bicgstab"} <= kinds
    assert all(o["step"]["converged"] for o in res)
    assert res[0]["step"]["newton_iterations"] == res[0]["step"]["iters"]


def test_a_rank_that_skips_a_collective_fails_the_launch():
    t = time.monotonic()
    with pytest.raises(Exception):
        ranks.launch(rank_checks.skip_collective, 2, "cpu", timeout=90,
                     pg_timeout=15)
    assert time.monotonic() - t < 90


def test_a_launch_past_its_time_limit_is_killed():
    t = time.monotonic()
    with pytest.raises(TimeoutError, match="killed"):
        ranks.launch(rank_checks.stall, 2, "cpu", (120.0,), timeout=6)
    assert time.monotonic() - t < 40


def test_no_fallback_to_fewer_cards_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="CUDA devices"):
        ranks.check_cards(2, "cuda")
    with pytest.raises(ValueError, match="CUDA devices"):
        ranks.launch(rank_checks.skip_collective, 2, "cuda", timeout=30)
    with pytest.raises(ValueError, match="at least one"):
        ranks.check_cards(0, "cpu")
    for main in (dd_scale.main, extended_scheme.main):
        with pytest.raises(SystemExit, match="must divide"):
            main(["--device", "cpu", "--devices", "3", "--cards", "2"])
    # the part-to-device list must put a rank's parts on its device
    m = StreamerModel(StreamerConfig(nx=4, ny=6), device="cpu")
    with ranks.one_rank("cpu") as g:
        with pytest.raises(ValueError, match="rank 0 runs on cpu"):
            m.distribute(["meta", "meta"], g)


def test_ranked_joins_a_torchrun_group(monkeypatch):
    """Under torchrun (its environment set) `ranked` joins that group, one
    rank per process, on a store at a localhost port."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ranks.under_torchrun()
    spec = dict(n=12, B=2, seed=6)
    out = ranks.ranked(rank_checks.reductions, 1, "cpu", (spec,))
    assert len(out) == 1 and out[0]["finite"] == (True, False)
    with pytest.raises(ValueError, match="torchrun started 1 ranks"):
        ranks.ranked(rank_checks.reductions, 2, "cpu", (spec,))
