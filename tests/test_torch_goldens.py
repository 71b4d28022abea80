"""The port held to the repo's pinned goldens (`tests/golden/`), with the
runs and bounds of the JAX package's own regressions
(`tests/verification/test_streamer.py`, `test_glow.py`):

- streamer: `StreamerConfig(nx=24, ny=40)` (float64), the initial state
  and 10 advances writing `relative error.log`;
- glow: the synthetic argon tree, `GlowConfig(nx=24, ny=24, ttol=2e-3)`,
  and 6 advances, each after `_update_aux`.

The error log within rtol 1e-5 of the golden; each column within L1 and
L2 < 1e-5 and Linf < 1e-3 of the golden state, relative to its max; `t` as
the JAX tests hold it (`pytest.approx` with rel 1e-12 for the streamer,
1e-10 for the glow).

The glow golden's `t` was pinned on another platform: on the CPU the JAX
package's own run lands 2.19e-10 relative from it, and so does the port's.
`pytest.approx(rel=1e-10)` passes both only through its default absolute
tolerance (1e-12, against t ~ 1.7e-11). So the glow's `t` is also held to
the JAX package's own run on this host, to 1e-12 relative (the port's gap
is ~4e-14)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.models.argon_synth import generate_argon_input as jax_argon
from fedm_tpu.models.glow import GlowConfig as JaxGlowConfig
from fedm_tpu.models.glow import GlowDischargeModel as JaxGlowModel
from fedm_tpu_torch.models.argon_synth import generate_argon_input
from fedm_tpu_torch.models.glow import GlowConfig, GlowDischargeModel
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs: the meshes are small, and
    the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def streamer_run(tmp_path_factory):
    m = StreamerModel(StreamerConfig(nx=24, ny=40), device="cpu")
    st = m.initial_state()
    err_log = tmp_path_factory.mktemp("streamer") / "relative error.log"
    d = m.make_driver(error_log=err_log)
    for _ in range(10):
        st = d.advance(st, {})
    return st, err_log


@pytest.fixture(scope="module")
def glow_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("argon_input")
    generate_argon_input(base)
    m = GlowDischargeModel(GlowConfig(file_input=base, nx=24, ny=24,
                                      ttol=2e-3), device="cpu")
    st = m.initial_state()
    err_log = tmp_path_factory.mktemp("glow") / "relative error.log"
    d = m.make_driver(error_log=err_log)
    for _ in range(6):
        st = d.advance(st, m._update_aux(st.u))
    return st, err_log


def _log(path: Path) -> np.ndarray:
    return np.loadtxt(path, ndmin=2)


def _fields_match(u: np.ndarray, ref: np.ndarray) -> None:
    for k in range(u.shape[1]):
        scale = np.max(np.abs(ref[:, k])) or 1.0
        err = (u[:, k] - ref[:, k]) / scale
        assert np.mean(np.abs(err)) < 1e-5, f"component {k}"
        assert np.sqrt(np.mean(err**2)) < 1e-5, f"component {k}"
        assert np.max(np.abs(err)) < 1e-3, f"component {k}"


@pytest.mark.parametrize("name", ["streamer", "glow"])
def test_error_trajectory_matches_golden(request, name):
    _, err_log = request.getfixturevalue(f"{name}_run")
    got = _log(err_log)
    ref = _log(GOLDEN / f"{name}_relative_error.log")
    assert got.shape == ref.shape
    assert np.allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("name,t_rel", [("streamer", 1e-12),
                                        ("glow", 1e-10)])
def test_fields_match_golden(request, name, t_rel):
    st, _ = request.getfixturevalue(f"{name}_run")
    ref = np.load(GOLDEN / f"{name}_final_state.npz")
    assert st.t == pytest.approx(float(ref["t"]), rel=t_rel)
    _fields_match(st.u.cpu().numpy(), ref["u"])


def test_glow_time_matches_the_jax_run(glow_run, tmp_path):
    """The JAX package's own glow run on this host, against which the
    port's `t` holds to 1e-12 relative (both miss the pinned golden `t` by
    the same 2.19e-10)."""
    base = tmp_path / "argon"
    jax_argon(base)
    m = JaxGlowModel(JaxGlowConfig(file_input=base, nx=24, ny=24,
                                   ttol=2e-3))
    st = m.initial_state()
    d = m.make_driver()
    for _ in range(6):
        st = d.advance(st, m._update_aux_jit(st.u))
    port, _ = glow_run
    assert abs(port.t - st.t) <= 1e-12 * st.t
    golden_t = float(np.load(GOLDEN / "glow_final_state.npz")["t"])
    # the same miss of the pinned value, to the last digits
    assert abs((port.t - golden_t) - (st.t - golden_t)) <= 1e-12 * st.t
    _fields_match(port.u.cpu().numpy(), np.asarray(st.u))
