"""The time-of-flight models of the port against the JAX package's on the
CPU, at a small width: 1D on 100 P2 cells (dt 1e-11) and 2D on a 10 x 10
P1 axisymmetric mesh (dt 1e-12 from 2.5e-9), 5 steps each (the first BDF1,
then BDF2). Held: the initial state, the residual and J v at a seeded
state (1e-13 relative), the Newton iterations of every step (exactly),
the state after every step and the relative L2 error at the end (both
1e-11 relative: Newton stops at rtol 1e-10, yet the two packages take the
same iterates to rounding). The control, the port run with BDF1 in every
step, must miss the JAX error by far more than that tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.model.system import StepParams as JParams
from fedm_tpu.models.tof import TimeOfFlight1D as J1
from fedm_tpu.models.tof import TimeOfFlight2D as J2
from fedm_tpu.models.tof import TofConfig as JCfg
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.tof import TimeOfFlight1D, TimeOfFlight2D, TofConfig

STATE_RTOL = 1e-11
ERROR_RTOL = 1e-11
OPS_RTOL = 1e-13
CASES = {
    "1d": (lambda: J1(JCfg(dt=1e-11, T_final=5e-11), n_cells=100),
           lambda: TimeOfFlight1D(TofConfig(dt=1e-11, T_final=5e-11),
                                  n_cells=100, device="cpu")),
    "2d": (lambda: J2(JCfg(t0=2.5e-9, T_final=2.505e-9, dt=1e-12), nx=10,
                      ny=10),
           lambda: TimeOfFlight2D(TofConfig(t0=2.5e-9, T_final=2.505e-9,
                                            dt=1e-12), nx=10, ny=10,
                                  device="cpu")),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread while this module runs: its tensors are small, and
    the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorded(model, params_of=None):
    """Wrap model.system.step to record (newton iterations, state) per
    step; `params_of` may rewrite the step parameters (the control)."""
    log = []
    step = model.system.step

    def run(u_guess, u_old, u_old1, aux, params):
        if params_of is not None:
            params = params_of(params)
        u, info = step(u_guess, u_old, u_old1, aux, params)
        log.append((int(info.iters), np.asarray(
            u.numpy() if isinstance(u, torch.Tensor) else u)))
        return u, info

    model.system.step = run
    return log


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    jm, tm = (make() for make in CASES[request.param])
    jlog, tlog = _recorded(jm), _recorded(tm)
    ju, jerr = jm.run()
    tu, terr = tm.run()
    return dict(jm=jm, tm=tm, jlog=jlog, tlog=tlog, jerr=jerr, terr=terr,
                ju=np.asarray(ju), tu=tu.numpy())


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def test_initial_state(runs):
    j0 = np.asarray(runs["jm"].initial_state())
    t0 = runs["tm"].initial_state()
    assert t0.dtype == torch.float64 and t0.shape == j0.shape
    assert _rel(t0.numpy(), j0) <= 1e-15


def test_residual_and_jacobian_action(runs):
    jm, tm = runs["jm"], runs["tm"]
    c = tm.cfg
    rng = np.random.default_rng(0)
    u_old = np.asarray(jm.initial_state())
    u_old1 = u_old - 1e-3 * rng.standard_normal(u_old.shape)
    u = u_old + 1e-3 * rng.standard_normal(u_old.shape)
    v = rng.standard_normal(u_old.shape)
    t, dt, dt_old = c.t0 + c.dt, c.dt, 1.3 * c.dt
    jp = JParams(jnp.asarray(t), jnp.asarray(dt), jnp.asarray(dt_old))
    fn = jm.system.make_residual_fn(jnp.asarray(u_old), jnp.asarray(u_old1),
                                    {}, jp)
    jF, jJv = jax.jvp(fn, (jnp.asarray(u),), (jnp.asarray(v),))
    T = torch.as_tensor
    p = StepParams(t, dt, dt_old)
    ops = tm.system.operators(T(u_old), T(u_old1), p)
    F = ops.residual(T(u - u_old))
    Jv = ops.jacobian_action(T(u - u_old))(T(v))
    assert _rel(F.numpy(), jF) <= OPS_RTOL
    assert _rel(Jv.numpy(), jJv) <= OPS_RTOL


def test_newton_iterations_per_step(runs):
    j = [n for n, _ in runs["jlog"]]
    assert [n for n, _ in runs["tlog"]] == j and len(j) == 5
    assert [int(i.iters) for i in runs["tm"].step_infos] == j


def test_state_per_step(runs):
    for (_, tu), (_, ju) in zip(runs["tlog"], runs["jlog"]):
        assert _rel(tu, ju) <= STATE_RTOL
    assert _rel(runs["tu"], runs["ju"]) <= STATE_RTOL


def test_relative_l2_error(runs):
    (tt, te), = runs["terr"]
    (jt, je), = runs["jerr"]
    assert tt == jt
    assert abs(te - je) / je <= ERROR_RTOL


def test_bdf1_throughout_is_refused(runs):
    """The control: the same port run with dt_old = 1e30 in every step
    (BDF1 throughout) misses the JAX package's error and states."""
    tm = [make for make in CASES["1d" if runs["tm"].space.mesh.dim == 1
                                 else "2d"]][1]()
    log = _recorded(tm, lambda p: p._replace(dt_old=1e30))
    tu, terr = tm.run()
    (_, te), = terr
    (_, je), = runs["jerr"]
    gap = abs(te - je) / je
    assert gap > 1e3 * ERROR_RTOL, gap
    assert _rel(tu.numpy(), runs["ju"]) > 1e3 * STATE_RTOL
    assert len(log) == 5
