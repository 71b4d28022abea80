"""`StreamerModel.from_file_input` of the port against the JAX package's,
on tests/unit/test_streamer_file_input.py's reference-format tree (the
Bagheri closed forms as `fun:E` expressions, LFA): the charge signs, the
compiled expressions against the built-in ones (1e-12), the initial
residual against the built-in model's (exactly: the same expressions),
and one float64 advance against the JAX package's file-input model (the
same counts, dt and fields to 1e-10 relative).
"""

import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu_torch.convert import state_from_arrays, state_to_arrays
from fedm_tpu_torch.model.approximation import modify_approximation_vars
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from tests.unit.test_streamer_file_input import benchmark_tree  # noqa: F401

SIZE = dict(nx=10, ny=14)


def test_from_file_input_matches_the_built_in_model(benchmark_tree):
    m = StreamerModel.from_file_input(benchmark_tree, device="cpu", **SIZE)
    assert m.SIGN == (1.0, -1.0)  # LFA dropped the neutrals
    assert m.cfg.poisson_precond == "mg"
    E = torch.tensor([3e5, 2.5e6, 1.2e7], dtype=torch.float64)
    for name, ref in (("_mu_e", 2.3987 * E ** (-0.26)),
                      ("_D_e", 4.3628e-3 * E ** 0.22),
                      ("_alpha", (1.1944e6 + 4.3666e26 * E ** -3)
                       * torch.exp(-2.73e7 / E) - 340.75)):
        np.testing.assert_allclose(getattr(m, name)(E_m=E).numpy(),
                                   ref.numpy(), rtol=1e-12)
    built_in = StreamerModel(StreamerConfig(**SIZE), device="cpu")
    s = m.initial_state()
    s0 = built_in.initial_state()
    assert torch.equal(s.u, s0.u)
    p = StepParams(s.dt, s.dt, s.dt_old)
    assert torch.equal(m.system.residual(s.u, s.u, s.u_old1, p),
                       built_in.system.residual(s0.u, s0.u, s0.u_old1, p))


def test_one_advance_against_jax(benchmark_tree):
    jm = JaxModel.from_file_input(benchmark_tree, **SIZE)
    tm = StreamerModel.from_file_input(benchmark_tree, device="cpu", **SIZE)
    js = jm.initial_state()
    ts = state_from_arrays(js, device="cpu")
    js = jm.make_driver().advance(js, {})
    got = state_to_arrays(tm.make_driver().advance(ts))
    assert got["n_accepted"] == js.n_accepted == 1
    assert got["n_rejected"] == js.n_rejected
    assert abs(got["dt"] - js.dt) <= 1e-10 * js.dt
    ref = np.asarray(js.u)
    for k in range(3):
        assert np.abs(got["u"][:, k] - ref[:, k]).max() <= \
            1e-10 * np.abs(ref[:, k]).max(), k


@pytest.mark.parametrize("kind,n_eq", [("LFA", 3), ("LMEA", 4)])
def test_approximation_vars(kind, n_eq):
    out = modify_approximation_vars(kind, 3, ["e_energy", "ions", "e"],
                                    [0.0, 4.7e-26, 9.1e-31], [0, 1, -1])
    assert out[1] == n_eq and len(out[2]) == n_eq - 1
    with pytest.raises(ValueError, match="not recognised"):
        modify_approximation_vars("XYZ", 1, ["a"], [1.0], [0])
