"""The round-1 route on ranks (`CoupledSystem.shard`, the JAX package's
`shard` of `tests/parallel/test_sharding.py`): every batch's elements
split over 2 gloo ranks in blocks, padded with elements that have no
scatter slot, each block scattered through its own ELL table (K1), the
state whole on every rank, assembly a local sum plus one all-reduce.

At `test_sharding.py`'s size (StreamerConfig(nx=12, ny=16), float64,
"mg"), from the port's initial state: the residual and the node blocks
against the one-process port at that test's tolerances (rtol 1e-8, atol
1e-10 of the largest entry), one step at rtol 1e-6, atol 1e-12, every
rank holding the same values; and against the JAX package's `shard` over
8 virtual devices, pinned below from `JAX_PLATFORMS=cpu python
tools/port_reference_gspmd.py --shard`: the residual's column norms and
the node blocks' per-entry norms at the same tolerances, the step's
Newton count equal and its column norms within 1e-6.
"""

import numpy as np
import pytest
import torch

from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.parallel import rank_checks, ranks

CFG = dict(nx=12, ny=16)
STEP = (5e-12, 5e-12, 1e30)
# tools/port_reference_gspmd.py --shard (JAX shard on 8 virtual devices)
JAX_SHARD = {
    "F_norms": [207174664442159.94, 207487021173619.75,
                6.013215175873742e-10],
    "B_norms": [[5.48262251001296e+19, 103615270046662.9,
                 17701131752.547276],
                [0.0, 6.838514160690723e+17, 1337558841210.6658],
                [4.960411869100249, 0.059746942087919794,
                 5.861824383224508]],
    "converged": True, "iters": 2,
    "u_norms": [454.4759333264392, 444.99812893281194, 193181.22578975206]}


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = StreamerModel(StreamerConfig(**CFG), device="cpu")
        u = m.initial_state().u
        p = StepParams(*STEP)
        one = {"F": m.system.residual(u, u, u, p),
               "B": m.system.operators(u, u, p).jacobian_blocks(
                   torch.zeros_like(u))}
        one["u"], info = m.system.step(u, u, u, {}, p)
        one["iters"] = int(info.iters)
        res = ranks.launch(rank_checks.shard, 2, "cpu", (
            {"cfg": CFG, "u": u.numpy(), "params": STEP},), timeout=300)
    finally:
        torch.set_num_threads(n)
    return one, res


def _close(got, ref, rtol):
    ref = ref.numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=1e-10 * np.abs(ref).max())


def test_shard_matches_one_process(runs):
    one, res = runs
    for r in res:
        _close(r["F"], one["F"], 1e-8)
        _close(r["B"], one["B"], 1e-8)
        assert r["converged"] and r["iters"] == one["iters"]
        np.testing.assert_allclose(r["u"].numpy(), one["u"].numpy(),
                                   rtol=1e-6, atol=1e-12)
        # each rank's blocks scatter through their own ELL tables (K1)
        assert all(r["launches"])
    assert all(torch.equal(res[0][k], res[1][k]) for k in ("F", "B", "u"))


def test_shard_matches_jax_shard(runs):
    _, res = runs
    F, B, u = (res[0][k].numpy() for k in ("F", "B", "u"))
    fn = [np.linalg.norm(F[:, k]) for k in range(3)]
    np.testing.assert_allclose(fn, JAX_SHARD["F_norms"], rtol=1e-8,
                               atol=1e-10 * max(JAX_SHARD["F_norms"]))
    bn = [[np.linalg.norm(B[:, i, j]) for j in range(3)] for i in range(3)]
    bmax = max(max(row) for row in JAX_SHARD["B_norms"])
    np.testing.assert_allclose(bn, JAX_SHARD["B_norms"], rtol=1e-8,
                               atol=1e-10 * bmax)
    assert (res[0]["converged"], res[0]["iters"]) == (
        JAX_SHARD["converged"], JAX_SHARD["iters"])
    np.testing.assert_allclose([np.linalg.norm(u[:, k]) for k in range(3)],
                               JAX_SHARD["u_norms"], rtol=1e-6)
