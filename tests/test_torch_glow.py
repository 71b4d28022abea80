"""The port's glow discharge (LMEA on the synthetic argon tree, crossed
8 x 8 mesh) against the JAX package's, piece by piece: the mesh,
`project`, the per-advance coefficients `_update_aux`, the initial state,
the float64 residual, Jacobian action, 5 x 5 node blocks and block + MG
preconditioner (1e-12 relative per equation, at a seeded state and at the
initial state, where the electrode fluxes sit on the ties of `Max` and
`abs`), the float64 defect of the float32 system, `invert_blocks` for
k = 1..8, the P1 transfers and the multigrid V-cycle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.fem import interpolation as jinterp
from fedm_tpu.fem.assembly import project as jax_project
from fedm_tpu.mesh import mark_boundaries as jax_mark
from fedm_tpu.mesh import rectangle_mesh as jax_rectangle_mesh
from fedm_tpu.model.system import StepParams as JaxParams
from fedm_tpu.models.argon_synth import generate_argon_input
from fedm_tpu.models.glow import GlowConfig as JaxConfig
from fedm_tpu.models.glow import GlowDischargeModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu.solvers.precond import invert_blocks as jax_invert_blocks
from fedm_tpu_torch.fem import FunctionSpace
from fedm_tpu_torch.fem import interpolation as tinterp
from fedm_tpu_torch.fem.assembly import project
from fedm_tpu_torch.mesh import mark_boundaries, rectangle_mesh
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.glow import GlowConfig, GlowDischargeModel
from fedm_tpu_torch.solvers.multigrid import GeometricMultigrid
from fedm_tpu_torch.solvers.newton import NewtonConfig
from fedm_tpu_torch.solvers.precond import invert_blocks

RTOL = 1e-12
N = 8
PARAMS = (2e-12, 1e-12, 8e-13)  # t, dt, dt_old
NEWTON = dict(rtol=1e-3, max_iter=20, linear_tol=1e-2, linear_maxiter=600,
              hi_residual=True)


def _close(got, ref, rtol=RTOL):
    """max |got - ref| <= rtol * max |ref|, per trailing component."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    g, r = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
    for k in range(r.shape[1]):
        scale = np.abs(r[:, k]).max()
        assert np.abs(g[:, k] - r[:, k]).max() <= rtol * scale, k


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("argon")
    generate_argon_input(base)
    return base


def _models(tree, jdt, tdt):
    jm = JaxModel(JaxConfig(file_input=tree, nx=N, ny=N, dtype=jdt,
                            newton=JaxNewton(**NEWTON, host_loop=True)))
    tm = GlowDischargeModel(GlowConfig(file_input=tree, nx=N, ny=N,
                                       dtype=tdt,
                                       newton=NewtonConfig(**NEWTON,
                                                           host_loop=True)),
                            device="cpu")
    jm.system.use_gather_scatter()
    tm.system.use_gather_scatter()
    return jm, tm


def _states(jm):
    """A seeded glow-like history (u_old1, u_old) and iterate u: the
    initial densities and mean energy with a cathode-fall-like potential,
    plus noise (1e-2 in the log-densities, 1 V in the potential)."""
    u0 = np.array(jm.initial_state().u)
    z = jm.space.dof_coords[:, 1]
    u0[:, 4] = -250.0 * (1.0 - z / 0.01) ** 2
    rng = np.random.default_rng(0)
    noise = np.array([1e-2, 1e-2, 1e-2, 1e-2, 1.0])
    u_old1 = u0 + noise * rng.standard_normal(u0.shape)
    u_old = u_old1 + noise * rng.standard_normal(u0.shape)
    u = u_old + noise * rng.standard_normal(u0.shape)
    return u, u_old, u_old1


def _jax_ops(S, u_old, u_old1, aux):
    jp = JaxParams(*map(jnp.asarray, PARAMS))
    (_, u_old_c, d_hist, aux_c, params_c, bc_shift) = S._cast_inputs(
        jnp.asarray(u_old), jnp.asarray(u_old), jnp.asarray(u_old1), aux, jp)
    R = S.make_delta_residual_fn(u_old_c, d_hist, aux_c, params_c, bc_shift)
    return R, (u_old_c, d_hist, aux_c, params_c)


@pytest.fixture(scope="module", params=["seeded", "initial"])
def f64(tree, request):
    """Both packages' operators at one state; `initial`: the model's
    initial state with delta = 0 (no field, uniform densities: zero
    electrode fluxes)."""
    jm, tm = _models(tree, jnp.float64, torch.float64)
    if request.param == "seeded":
        u, u_old, u_old1 = _states(jm)
    else:
        u_old = np.asarray(jm.initial_state().u)
        u = u_old1 = u_old
    aux_j = jm._update_aux_jit(jnp.asarray(u_old))
    R, args = _jax_ops(jm.system, u_old, u_old1, aux_j)
    aux_t = {k: _t(v) for k, v in aux_j.items()}
    ops = tm.system.operators(_t(u_old), _t(u_old1), StepParams(*PARAMS),
                              aux=aux_t)
    return dict(jm=jm, tm=tm, R=R, args=args, ops=ops, delta=u - u_old,
                u_old=u_old)


@pytest.mark.parametrize("diagonal", ["right", "left", "crossed"])
def test_rectangle_mesh_is_the_jax_package_mesh(diagonal):
    jmesh = jax_rectangle_mesh((0, 0), (0.01, 0.02), 5, 7, diagonal)
    tmesh = rectangle_mesh((0, 0), (0.01, 0.02), 5, 7, diagonal)
    np.testing.assert_array_equal(tmesh.coords, jmesh.coords)
    np.testing.assert_array_equal(tmesh.cells, jmesh.cells)
    np.testing.assert_array_equal(tmesh.boundary_facets,
                                  jmesh.boundary_facets)
    np.testing.assert_array_equal(tmesh.boundary_cells, jmesh.boundary_cells)
    lines = [["line", 0.0, 0.0, 0.0, 0.01], ["line", 0.02, 0.02, 0.0, 0.01],
             ["line", 0.0, 0.02, 0.0, 0.0], ["line", 0.0, 0.02, 0.01, 0.01]]
    np.testing.assert_array_equal(mark_boundaries(tmesh, lines),
                                  jax_mark(jmesh, lines))


def test_crossed_glow_mesh_and_its_ell_table(tree):
    jm, tm = _models(tree, jnp.float64, torch.float64)
    assert tm.space.n_dofs == (N + 1) ** 2 + N * N == 145
    assert tm.batch._structured is None  # the crossed mesh is not
    np.testing.assert_array_equal(tm.batch.gather_idx.numpy(),
                                  np.asarray(jm.batch.gather_idx)[0])
    assert tuple(tm.batch.gather_idx.shape) == (145, 8)
    assert tm.batch.scatter_rows is None  # every dof is live: dense form


@pytest.mark.parametrize("lumped", [False, True])
def test_project(tree, lumped):
    jm, tm = _models(tree, jnp.float64, torch.float64)
    s_q = np.random.default_rng(4).uniform(0.0, 50.0,
                                            tuple(jm.batch.scale.shape))
    ref = jax_project(jnp.asarray(s_q), jm.batch, lumped=lumped)
    got = project(_t(s_q), tm.batch, lumped=lumped)
    _close(got, ref)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_update_aux(tree, dtype):
    """float64: 1e-12. float32: the reduced field is projected by a
    float32 CG in both packages, whose rounding differs (measured 1.5e-6);
    the float64 table lookups at the float64 mean energy still agree to
    1e-12."""
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    jm, tm = _models(tree, jdt, tdt)
    _, u_old, _ = _states(jm)
    ref = jm._update_aux_jit(jnp.asarray(u_old))
    got = tm._update_aux(_t(u_old))
    assert ref.keys() == got.keys()
    for k in ref:
        assert got[k].dtype == {jnp.float64: torch.float64,
                                jnp.float32: torch.float32}[ref[k].dtype.type]
        field_dependent = dtype == "f32" and k in ("redE", "mu", "D")
        _close(got[k], ref[k], 5e-6 if field_dependent else RTOL)


def test_initial_state(tree):
    jm, tm = _models(tree, jnp.float64, torch.float64)
    js, ts = jm.initial_state(), tm.initial_state()
    for k in ("u", "u_old", "u_old1"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)))
    assert (ts.t, ts.dt, ts.dt_old) == (js.t, js.dt, js.dt_old)


def test_residual(f64):
    _close(f64["ops"].residual(_t(f64["delta"])),
           f64["R"](jnp.asarray(f64["delta"])))


def test_jacobian_action(f64):
    v = np.random.default_rng(1).standard_normal(f64["delta"].shape)
    _, ref = jax.jvp(f64["R"], (jnp.asarray(f64["delta"]),),
                     (jnp.asarray(v),))
    got = f64["ops"].jacobian_action(_t(f64["delta"]))(_t(v))
    _close(got, ref)


def test_node_blocks(f64):
    ref = np.asarray(f64["jm"].system._jacobian_blocks(
        jnp.asarray(f64["delta"]), *f64["args"]))
    got = f64["ops"].jacobian_blocks(_t(f64["delta"])).numpy()
    assert got.shape == (145, 5, 5)
    zero = np.all(ref == 0, axis=0)
    assert np.all(got[:, zero] == 0)
    _close(got[:, ~zero], ref[:, ~zero])


def test_block_and_multigrid_preconditioner(f64):
    r = np.random.default_rng(2).standard_normal(f64["delta"].shape)
    M = f64["jm"].system.block_precond_builder(*f64["args"])(
        jnp.asarray(f64["delta"]))
    got = f64["tm"].system.block_precond_builder(f64["ops"])(
        _t(f64["delta"]))(_t(r))
    _close(got, M(jnp.asarray(r)))


def test_float64_defect_of_the_float32_system(tree):
    jm, tm = _models(tree, jnp.float32, torch.float32)
    _, u_old, u_old1 = _states(jm)
    aux = jm._update_aux_jit(jnp.asarray(u_old))
    R = jm.system._make_hi_residual(jnp.asarray(u_old), jnp.asarray(u_old1),
                                    aux, JaxParams(*map(jnp.asarray, PARAMS)))
    ref = R(jnp.zeros(u_old.shape, jnp.float32))
    got = tm.system.residual(_t(u_old), _t(u_old), _t(u_old1),
                             StepParams(*PARAMS), torch.float64,
                             aux={k: _t(v) for k, v in aux.items()})
    assert got.dtype == torch.float64
    _close(got, ref)


def _blocks(k, n=257, seed=5):
    """Seeded k x k blocks with rows of very different scales (as the
    coupled blocks have), one of them with a zero column."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, k, k)) + 3.0 * np.eye(k)
    A *= 10.0 ** rng.uniform(-20, 20, (n, k, 1))
    A[7, :, k - 1] = 0.0  # structurally singular: the Jacobi fallback
    return A


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8])
def test_invert_blocks(k):
    A = _blocks(k)
    if k == 1:
        A[7] = 0.0
    ref, ref_n = jax_invert_blocks(jnp.asarray(A), with_count=True)
    got, n = invert_blocks(_t(A), with_count=True)
    assert n == int(ref_n) == 1
    _close(got, ref)


def test_invert_blocks_float32_acts_as_the_float64_inverse():
    """In float32 the pivots may differ from float64's on near-ties; the
    preconditioned result is held by its effect: inv(A) A v = v. Blocks:
    well-conditioned, rows of very different scales, and rows that tie in
    the pivot column."""
    rng = np.random.default_rng(6)
    A = rng.standard_normal((257, 5, 5)) + 10.0 * np.eye(5)
    A[::2, 1, 0] = A[::2, 0, 0]  # a pivot tie in the first column
    A *= 10.0 ** rng.uniform(-20, 20, (257, 5, 1))
    inv = invert_blocks(_t(A).float()).double()
    v = rng.standard_normal((len(A), 5))
    Av = np.einsum("nij,nj->ni", A, v)
    back = torch.einsum("nij,nj->ni", inv, _t(Av)).numpy()
    assert np.abs(back - v).max() <= 1e-5 * np.abs(v).max()


def test_p1_transfers(tree):
    fine = rectangle_mesh((0, 0), (0.01, 0.01), N, N, "crossed")
    coarse = rectangle_mesh((0, 0), (0.01, 0.01), N // 2, N // 2, "crossed")
    jf = jax_rectangle_mesh((0, 0), (0.01, 0.01), N, N, "crossed")
    jc = jax_rectangle_mesh((0, 0), (0.01, 0.01), N // 2, N // 2, "crossed")
    from fedm_tpu.fem.space import FunctionSpace as JaxSpace

    jidx, jw = jinterp.p1_transfer(JaxSpace(jc, 1), JaxSpace(jf, 1))
    idx, w = tinterp.p1_transfer(FunctionSpace(coarse), FunctionSpace(fine),
                                 device="cpu")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    rng = np.random.default_rng(8)
    uc = rng.standard_normal(coarse.n_verts)
    rf = rng.standard_normal(fine.n_verts)
    _close(tinterp.prolong(idx, w, _t(uc)),
           jinterp.prolong(jidx, jw, jnp.asarray(uc)))
    _close(tinterp.restrict(idx, w, _t(rf), coarse.n_verts),
           jinterp.restrict(jidx, jw, jnp.asarray(rf), coarse.n_verts))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_multigrid_vcycle(tree, dtype):
    """The Poisson-row V-cycle: float64 to 1e-12; float32 to 1e-5 (the
    same float32 arithmetic in another summation order)."""
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    jm, tm = _models(tree, jdt, tdt)
    assert len(tm.mg.levels) == 2 and tm.mg.levels[-1].n == 41
    r = np.random.default_rng(9).standard_normal(145).astype(
        np.float64 if dtype == "f64" else np.float32)
    ref = jm.system._ell[1](jnp.asarray(r))
    got = tm.mg.precond(_t(r))
    assert got.dtype == tdt
    _close(got, ref, RTOL if dtype == "f64" else 1e-5)


def test_multigrid_refuses_tensor_product_levels():
    """Tensor-product levels, once refused, now take the JAX package's
    stencil branch: the fine level's operator is its extracted 9-point
    stencil, the transfer the separable one, and the V-cycle equals the
    JAX package's to 1e-12 in float64."""
    from fedm_tpu.fem import FunctionSpace as JaxSpace
    from fedm_tpu.solvers.multigrid import GeometricMultigrid as JaxMG
    from fedm_tpu_torch.fem.interpolation import StructuredTransfer
    from fedm_tpu_torch.solvers.stencil import StencilOp

    spaces, jspaces = [], []
    for n in (8, 4):
        spaces.append(FunctionSpace(rectangle_mesh((0, 0), (1, 1), n, n)))
        jspaces.append(JaxSpace(jax_rectangle_mesh((0, 0), (1, 1), n, n), 1))
    masks = [np.isclose(s.dof_coords[:, 1], 0.0)
             | np.isclose(s.dof_coords[:, 1], 1.0) for s in spaces]
    mg = GeometricMultigrid(spaces, masks, axisymmetric=True, device="cpu")
    jmg = JaxMG(jspaces, masks, axisymmetric=True)
    assert isinstance(mg.ops[0], StencilOp)
    assert isinstance(mg.transfers[0], StructuredTransfer)
    r = np.random.default_rng(10).standard_normal(spaces[0].n_dofs)
    _close(mg.precond(_t(r)), jmg.precond(jnp.asarray(r)))


@pytest.mark.parametrize("fn", ["Max", "abs"])
def test_max_and_abs_and_their_tangents_at_ties(fn):
    """Values, and the tangent at a tie, where `jnp.abs` differentiates
    to +1 (the electrode's ion outflux and drift terms at zero field)."""
    from fedm_tpu.model import forms as jforms
    from fedm_tpu_torch.model import forms

    ref_fn, port_fn = {
        "Max": (lambda x: jforms.Max(x, 0.0), lambda x: forms.Max(x, 0.0)),
        "abs": (jnp.abs, forms.abs_)}[fn]
    a = np.array([-2.0, -0.0, 0.0, 0.5, 3.0])
    ta = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    ref_v, ref_t = jax.jvp(ref_fn, (jnp.asarray(a),), (jnp.asarray(ta),))
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        got_v, got_t = fwAD.unpack_dual(
            port_fn(fwAD.make_dual(_t(a), _t(ta))))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))


@pytest.mark.parametrize("t", [0.0, 3e-10, 2e-9])
def test_bcset_values_at_matches_the_jax_values(t):
    """Dirichlet values at time t, the later condition winning on shared
    dofs as in the JAX package: a ramp (a callable giving a number), an
    array over its dofs, and a constant."""
    from fedm_tpu.fem.dirichlet import BCSet as JaxBCSet
    from fedm_tpu.fem.dirichlet import DirichletBC as JaxBC
    from fedm_tpu.fem.space import FunctionSpace as JaxSpace
    from fedm_tpu_torch.fem import BCSet, DirichletBC

    mesh = rectangle_mesh((0, 0), (0.01, 0.01), 4, 4, "crossed")
    jmesh = jax_rectangle_mesh((0, 0), (0.01, 0.01), 4, 4, "crossed")

    def specs(ramp):
        return [(np.arange(0, 5), 4, ramp),
                (np.arange(3, 8), 4, np.linspace(1.0, 2.0, 5)),
                (np.arange(10, 14), 1, -0.5)]

    got = BCSet(FunctionSpace(mesh), 5, [
        DirichletBC(*s) for s in specs(lambda s: -250.0 * (
            1.0 - np.exp(-s / 1e-9)))], device="cpu").values_at(t)
    ref = JaxBCSet(JaxSpace(jmesh, 1), 5, [
        JaxBC(*s) for s in specs(lambda s: -250.0 * (
            1.0 - jnp.exp(-s / 1e-9)))]).values(t)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
