"""`fedm_tpu_torch.parallel.rank_probe` on the CPU: one rank's element
kernels, op by op, its scatter, its halo reduction and its node-block
tangents equal the stacked run's rows bit for bit (the extended scheme,
8 x 8, 4 parts, rank 1 of 2; also with the cells' gradient summed term by
term, the probe's control), and the op walk names the first op whose
output differs."""

import pytest
import torch

from fedm_tpu_torch.parallel import rank_probe


@pytest.mark.parametrize("grad_by_terms", [False, True])
def test_a_rank_is_the_stacked_run_op_by_op_on_the_cpu(grad_by_terms):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = rank_probe.probe("cpu", nx=8, ny=8, n_parts=4, n_ranks=2,
                               ranks=[1], grad_by_terms=grad_by_terms)
    finally:
        torch.set_num_threads(n)
    (r,) = out["by_rank"]
    assert r["rank"] == 1 and r["ctx"] == {}
    assert len(r["kernels"]) == 2   # the cell batch and the facets
    for k in r["kernels"]:
        assert k["output"]["equal"], k
        assert k["ops"].get("all_equal") and k["ops"]["ops"] > 100, k
    for key in ("scatter", "halo_reduce", "blocks_scatter"):
        assert r[key]["equal"], (key, r[key])
    assert r["tangents"] and all(t["equal"] for t in r["tangents"])


def test_the_op_walk_names_the_first_differing_op():
    a = torch.arange(8.0)
    full = [("aten.mul", [(8,)], [a * 2]), ("aten.sum", [(8,)], [a + 1]),
            ("aten.add", [(8,)], [a])]
    part = [("aten.mul", [(4,)], [(a * 2)[4:]]),
            ("aten.sum", [(4,)], [torch.nextafter((a + 1)[4:],
                                                   torch.tensor(99.0))]),
            ("aten.add", [(4,)], [a[4:]])]
    got = rank_probe._first_op_gap(full, part, 1, 2)
    assert got["first_differing_op"] == 1 and got["op"] == "aten.sum"
    assert got["previous_ops"] == ["aten.mul"]
    part[1] = ("aten.sum", [(4,)], [(a + 1)[4:]])
    assert rank_probe._first_op_gap(full, part, 1, 2)["all_equal"]
