"""The last one-card definitions of the JAX package that the port lacked,
each against the JAX function on the CPU, on inputs seeded by numpy:

- `NewtonConfig.freeze_precond` (the block preconditioner built once, at
  the first iterate, by the whole-solve loop): one step of the 10 x 14
  streamer through `newton_krylov` with the same Newton iterations, the
  final ||F|| within 1e-8 relative and the state within 1e-13 of each
  column's max (CPU gaps 1e-9 and 1.9e-16), where the step without the
  freeze fails the state tolerance against the frozen JAX step; the
  batched loop's frozen step of each member equals its single frozen
  step's iterations, its state within 1e-12 of each column's max;
- `invert_blocks(..., reg=...)`, the Tikhonov diagonal, to 1e-13 of each
  block's largest entry, with exactly singular blocks that the
  regularisation makes invertible;
- `species_sources` and `semi_implicit_coefficient` to 1e-13 relative;
- `mark_boundaries`' 'circle' and 'point' entries and its `gap_length`,
  `line_tol` and `circle_tol` keywords: the markers equal the JAX
  package's, on a rectangle and on a 1D interval mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.chemistry import sources as jsrc
from fedm_tpu.mesh import interval_mesh as jax_interval
from fedm_tpu.mesh import mark_boundaries as jax_mark
from fedm_tpu.mesh import rectangle_mesh as jax_rectangle
from fedm_tpu.model.system import StepParams as JParams
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu.solvers.precond import invert_blocks as jax_invert
from fedm_tpu_torch.chemistry import (semi_implicit_coefficient,
                                      species_sources)
from fedm_tpu_torch.mesh import interval_mesh, mark_boundaries, rectangle_mesh
from fedm_tpu_torch.model.system import BatchedSystem, StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.solvers.newton import NewtonConfig
from fedm_tpu_torch.solvers.precond import invert_blocks

PARAMS = (5e-12, 5e-12, 1e30)
RES_RTOL, STATE_RTOL, BATCH_RTOL = 1e-8, 1e-13, 1e-12


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _col_gap(u, ref):
    return (np.abs(u - ref).max(axis=0) / np.abs(ref).max(axis=0)).max()


@pytest.fixture(scope="module")
def frozen_steps():
    """The JAX package's frozen step, and the port's frozen and unfrozen
    steps, from the JAX initial state of the 10 x 14 streamer."""
    jm = JaxModel(JaxConfig(nx=10, ny=14,
                            newton=JaxNewton(freeze_precond=True)))
    js = jm.initial_state()
    ju, jinfo = jm.system.step(js.u, js.u, js.u, {},
                               JParams(*(jnp.asarray(x) for x in PARAMS)))
    u0 = torch.as_tensor(np.array(js.u))
    out = {"jax": (np.asarray(ju), int(jinfo.iters), float(jinfo.res_norm)),
           "u0": u0}
    for frozen in (True, False):
        m = StreamerModel(StreamerConfig(
            nx=10, ny=14, newton=NewtonConfig(freeze_precond=frozen)),
            device="cpu")
        built = []
        system = m.system
        pb = system.block_precond_builder

        def counting(*a, pb=pb, **kw):
            build = pb(*a, **kw)
            return lambda d: (built.append(1), build(d))[1]

        system.block_precond_builder = counting
        u, info = system.step(u0, u0, u0, {}, StepParams(*PARAMS))
        del system.block_precond_builder
        out[frozen] = (u.numpy(), info, len(built), m)
    return out


def test_freeze_precond_matches_the_jax_whole_solve_loop(frozen_steps):
    ju, jiters, jres = frozen_steps["jax"]
    u, info, built, _ = frozen_steps[True]
    assert info.converged and info.iters == jiters >= 2
    assert built == 1           # one preconditioner for every iterate
    assert abs(info.res_norm - jres) <= RES_RTOL * jres
    assert _col_gap(u, ju) <= STATE_RTOL
    # the control: the preconditioner built at every iterate
    u2, info2, built2, _ = frozen_steps[False]
    assert built2 == info2.iters
    assert _col_gap(u2, ju) > STATE_RTOL


def test_freeze_precond_in_the_batched_loop(frozen_steps):
    u0 = frozen_steps["u0"]
    _, _, _, m = frozen_steps[True]
    rng = np.random.default_rng(5)
    members = [u0, u0 * (1 + 1e-6 * torch.as_tensor(
        rng.standard_normal(tuple(u0.shape))))]
    u = torch.stack(members)
    bs = BatchedSystem(m.system, 2)
    p = StepParams(*(np.full(2, x) for x in PARAMS))
    ub, info = bs.step(u, u, u, {}, p)
    for b, ui in enumerate(members):
        us, si = m.system.step(ui, ui, ui, {}, StepParams(*PARAMS))
        assert int(info.iters[b]) == si.iters and bool(info.converged[b])
        assert _col_gap(ub[b].numpy(), us.numpy()) <= BATCH_RTOL


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_invert_blocks_reg(k):
    rng = np.random.default_rng(20 + k)
    A = rng.standard_normal((64, k, k)) * 10.0 ** rng.integers(
        -8, 8, size=(64, k, 1))
    A[:4] = 0.0                  # exactly singular: reg makes them I/reg
    A[4:8, :, 0] = 0.0           # a zero column
    for reg in (0.0, 1e-3):
        ref = np.asarray(jax_invert(jnp.asarray(A), reg=reg))
        got = invert_blocks(torch.as_tensor(A), reg=reg).numpy()
        scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
        assert np.isfinite(got).all()
        assert (np.abs(got - ref) <= 1e-13 * scale).all()
    np.testing.assert_allclose(got[:4], np.eye(k)[None] / 1e-3 + 0 * got[:4],
                               rtol=1e-14)


def test_species_sources_and_semi_implicit_coefficient():
    rng = np.random.default_rng(7)
    n_r, n_sp = 9, 6
    rates = rng.standard_normal((5, 11, n_r)) * 1e20
    L = rng.integers(0, 3, size=(n_r, n_sp)).astype(float)
    G = rng.integers(0, 3, size=(n_r, n_sp)).astype(float)
    ref = np.asarray(jsrc.species_sources(jnp.asarray(rates), L, G))
    got = species_sources(torch.as_tensor(rates), L, G).numpy()
    assert (np.abs(got - ref) <= 1e-13 * np.abs(ref).max()).all()
    k, dk, e1, e0 = (rng.standard_normal((7, 3)) * s
                     for s in (1e-14, 1e-15, 5.0, 5.0))
    ref = np.asarray(jsrc.semi_implicit_coefficient(
        *(jnp.asarray(x) for x in (k, dk, e1, e0))))
    got = semi_implicit_coefficient(
        *(torch.as_tensor(x) for x in (k, dk, e1, e0))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mark_boundaries_circle_and_keywords(seed):
    """Circles through the middle of the cathode and the anode (a facet
    hits where its points' squared distance lies within `circle_tol` of
    radius^2, on the gap's side), lines widened by `line_tol`."""
    rng = np.random.default_rng(seed)
    gap = 0.01
    jm = jax_rectangle((0, 0), (0.01, gap), 12, 14, "crossed")
    tm = rectangle_mesh((0, 0), (0.01, gap), 12, 14, "crossed")
    rad = 0.004 + 0.002 * rng.random()
    cr = 0.003 + 0.004 * rng.random()
    ctol = float(10.0 ** rng.uniform(-5.5, -5.0))
    ltol = 1e-4 * rng.random()
    bnds = [["line", 0.0, gap, 0.0, 0.0],
            ["circle", -rad, cr, rad], ["circle", gap + rad, cr, rad],
            ["line", -ltol / 2, ltol / 2, 0.0, 0.01]]
    # the anode's z may round below the gap: the side test gets a margin
    kw = dict(gap_length=gap - 1e-9, line_tol=ltol, circle_tol=ctol)
    got = mark_boundaries(tm, bnds, **kw)
    np.testing.assert_array_equal(got, jax_mark(jm, bnds, **kw))
    np.testing.assert_array_equal(tm.facet_markers, got)
    # the cathode circle is overridden by the later line; the anode one
    # marks some facets
    assert (got == 3).any() and (got == 4).any()
    # a gap_length beyond the anode: no point is on the anode circle's
    # side, in both packages
    kw["gap_length"] = 2 * gap
    np.testing.assert_array_equal(mark_boundaries(tm, bnds, **kw),
                                  jax_mark(jm, bnds, **kw))
    assert not (mark_boundaries(tm, bnds, **kw) == 3).any()


def test_mark_boundaries_points_on_a_1d_mesh():
    jm, tm = jax_interval(40, 0.0, 1e-3), interval_mesh(40, 0.0, 1e-3)
    for bnds, kw in (([["point", 0.0], ["point", 1e-3]], {}),
                     ([["point", 1e-3 + 1e-9]], {"line_tol": 1e-8}),
                     ([["point", 1e-3 + 1e-9]], {})):
        got = mark_boundaries(tm, bnds, **kw)
        np.testing.assert_array_equal(got, jax_mark(jm, bnds, **kw))
    assert (mark_boundaries(tm, [["point", 1e-3 + 1e-9]],
                            line_tol=1e-8) == 1).sum() == 1
    with pytest.raises(ValueError, match="1D"):
        mark_boundaries(rectangle_mesh((0, 0), (1, 1), 2, 2, "right"),
                        [["point", 0.0]])
    with pytest.raises(ValueError, match="Invalid boundary type"):
        mark_boundaries(tm, [["sphere", 0.0]])
