"""The port on the card: both forms of the ELL gather-sum kernel (dense and
compact) against their plain versions, and the streamer main path on CUDA
at a small size against the same path on the CPU.

These tests are marked `gpu` and skip without a CUDA device. They import
only the port, so they also run where JAX is not installed; on a GPU host
run them (without the JAX-configuring conftest) with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from fedm_tpu_torch.convert import state_from_arrays
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.ops.ell_scatter import (ell_scatter, ell_scatter_add_,
                                            ell_scatter_add_ref,
                                            ell_scatter_ref, launch_count)
from fedm_tpu_torch.solvers.newton import NewtonConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_event_ms_of_a_copy_lies_above_its_memory_bound(cuda):
    """`devtime.event_ms`, the timing `device_ms` falls back to where the
    profiler drops its traces: a 256 MiB device copy takes between its HBM
    bound and three times it."""
    from fedm_tpu_torch.devtime import HBM_BYTES_PER_S, event_ms

    src = torch.ones(2**26, dtype=torch.float32, device=cuda)
    dst = torch.empty_like(src)
    ms = event_ms(lambda: dst.copy_(src), [()] * 10)
    bound = 2 * src.numel() * src.element_size() / HBM_BYTES_PER_S * 1e3
    assert bound <= ms <= 3 * bound
    assert torch.equal(dst, src)


def _ell_case(C, seed=0):
    """The case of tests/unit/test_pallas_scatter.py with a trailing width
    C: random rows, about a fifth of the entries the padding sentinel."""
    rng = np.random.default_rng(seed)
    n_flat, n_dofs, val = 301, 100, 7
    flat = rng.standard_normal((n_flat, C))
    idx = rng.integers(0, n_flat, (n_dofs, val))
    idx[rng.random((n_dofs, val)) < 0.2] = n_flat
    return flat, idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [1, 3, 9])
def test_ell_scatter_kernel_matches_plain(cuda, C, dtype):
    flat, idx = _ell_case(C)
    f = torch.as_tensor(flat, dtype=dtype, device=cuda)
    i = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    before = launch_count("ell_scatter")
    out = ell_scatter(f, i)
    torch.cuda.synchronize()
    assert launch_count("ell_scatter") == before + 1
    ref = ell_scatter_ref(f, i)
    # float64: exact up to summation order; float32: rtol 1e-6
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    assert out.shape == (100, C) and out.dtype == dtype
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=rtol * np.abs(flat).max())


def test_ell_scatter_raises_on_what_it_does_not_take(cuda):
    flat, idx = _ell_case(3)
    f = torch.as_tensor(flat, device=cuda)
    i = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ell_scatter(f.half(), i)
    with pytest.raises(TypeError):
        ell_scatter(f, i.long())
    with pytest.raises(ValueError):
        ell_scatter(f.t().contiguous().t(), i)
    with pytest.raises(ValueError):
        ell_scatter(f, i.cpu())


def _compact_case(max_val, C, n_live, seed=0):
    """A compact table: `n_live` distinct ascending destination rows of 100
    (None: every row), each with `max_val` random rows of a 301-row flat,
    about a fifth of them the padding sentinel."""
    rng = np.random.default_rng(seed)
    n_dofs, n_flat = 100, 301
    rows = None if n_live is None else np.sort(
        rng.permutation(n_dofs)[:n_live])
    n_rows = n_dofs if rows is None else n_live
    idx = rng.integers(0, n_flat, (n_rows, max_val))
    idx[rng.random((n_rows, max_val)) < 0.2] = n_flat
    flat = rng.standard_normal((n_flat, C))
    out = rng.standard_normal((n_dofs, C))
    return rows, idx, flat, out


@pytest.mark.parametrize("n_live", [37, 0, None], ids=["rows", "none-live",
                                                        "rows-None"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [1, 3, 9])
@pytest.mark.parametrize("max_val", [1, 2, 3, 6, 8, 11])
def test_ell_scatter_add_kernel_matches_plain(cuda, max_val, C, dtype,
                                              n_live):
    rows, idx, flat, out = _compact_case(max_val, C, n_live)
    r = None if rows is None else torch.as_tensor(rows, dtype=torch.int32,
                                                  device=cuda)
    i = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    f = torch.as_tensor(flat, dtype=dtype, device=cuda)
    o = torch.as_tensor(out, dtype=dtype, device=cuda)
    o0 = o.clone()
    before = launch_count("ell_scatter_add_")
    dense_before = launch_count("ell_scatter")
    got = ell_scatter_add_(o, f, i, r)
    torch.cuda.synchronize()
    assert got is o
    assert launch_count("ell_scatter_add_") == before + (n_live != 0)
    assert launch_count("ell_scatter") == dense_before
    ref = ell_scatter_add_ref(o0.clone(), f, i, r)
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(o.cpu().numpy(), ref.cpu().numpy(), rtol=rtol,
                               atol=rtol * np.abs(ref.cpu().numpy()).max())
    # the rows the table leaves out keep their values exactly
    if rows is not None:
        dead = np.setdiff1d(np.arange(100), rows)
        assert torch.equal(o[dead], o0[dead])


def test_ell_scatter_add_raises_on_what_it_does_not_take(cuda):
    rows, idx, flat, out = _compact_case(2, 3, 37)
    r = torch.as_tensor(rows, dtype=torch.int32, device=cuda)
    i = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    f = torch.as_tensor(flat, device=cuda)
    o = torch.as_tensor(out, device=cuda)
    with pytest.raises(TypeError):  # int64 idx
        ell_scatter_add_(o, f, i.long(), r)
    with pytest.raises(TypeError):  # int64 rows
        ell_scatter_add_(o, f, i, r.long())
    with pytest.raises(ValueError):  # non-contiguous out
        ell_scatter_add_(o.t().contiguous().t(), f, i, r)
    with pytest.raises(ValueError):  # idx stored as its transpose
        ell_scatter_add_(o, f, i.t().contiguous().t(), r)
    with pytest.raises(TypeError):  # mixed dtypes
        ell_scatter_add_(o.float(), f, i, r)
    with pytest.raises(TypeError):  # a dtype the kernel does not take
        ell_scatter_add_(o.half(), f.half(), i, r)
    with pytest.raises(ValueError):  # mixed devices
        ell_scatter_add_(o, f.cpu(), i, r)
    with pytest.raises(ValueError):
        ell_scatter_add_(o.cpu(), f, i, r)
    with pytest.raises(ValueError):
        ell_scatter_add_(o, f, i, r.cpu())
    with pytest.raises(ValueError):  # out that autograd tracks
        ell_scatter_add_(o.clone().requires_grad_(), f, i, r)


def _small_model(device):
    nc = NewtonConfig(rtol=1e-3, max_iter=20, linear_tol=1e-4,
                      linear_maxiter=200, accept_reduction=3e-2,
                      hi_residual=True, host_loop=True)
    cfg = StreamerConfig(z_corridor=(7e-3, 8.5e-3, 5e-5), newton=nc,
                         r_corridor=(2e-3, 2e-4), z_tail_cells=(12, 12),
                         mg_levels=3, poisson_precond="mg-zline",
                         dtype=torch.float32, density_floor=1e13)
    model = StreamerModel(cfg, device=device)
    model.system.use_gather_scatter()
    return model


def _uniform_state(model):
    """Uniform 1e13 m^-3 background with the exact (charge-free) linear
    potential between the electrodes."""
    z = model.space.dof_coords[:, 1]
    u = np.stack([np.full_like(z, np.log(1e13)), np.full_like(z, np.log(1e13)),
                  model.cfg.U_w * z / model.cfg.box_height], axis=-1)
    return dict(u=u, u_old=u, u_old1=u, t=0.0, dt=1e-12, dt_old=1e30,
                max_error=np.ones(3), n_accepted=0, n_rejected=0)


def test_main_path_small_on_cuda(cuda):
    gpu, cpu = _small_model(cuda), _small_model("cpu")
    arrays = _uniform_state(cpu)
    sg = state_from_arrays(arrays, device=cuda)
    sc = state_from_arrays(arrays, device="cpu")
    rng = np.random.default_rng(0)
    # perturbation: 1e-3 in the log-densities, 10 V in the potential (a
    # Poisson residual far from its cancelling linear-ramp solution)
    u = arrays["u"] + rng.standard_normal(arrays["u"].shape) * [1e-3, 1e-3,
                                                                10.0]
    p = StepParams(1e-12, 1e-12, 1e30)
    Fg = gpu.system.residual(torch.as_tensor(u, device=cuda), sg.u, sg.u_old,
                             p, torch.float64).cpu().numpy()
    Fc = cpu.system.residual(torch.as_tensor(u), sc.u, sc.u_old, p,
                             torch.float64).numpy()
    for k in range(3):
        assert np.abs(Fg[:, k] - Fc[:, k]).max() <= 1e-12 * np.abs(
            Fc[:, k]).max()

    before = launch_count("ell_scatter_add_")
    dense_before = launch_count("ell_scatter")
    sg = gpu.make_driver().advance(sg)
    sc = cpu.make_driver().advance(sc)
    # the residual accumulates the facet terms with the compact form only
    assert launch_count("ell_scatter_add_") > before
    assert launch_count("ell_scatter") == dense_before
    assert sg.n_accepted == sc.n_accepted == 1
    assert sg.t == sc.t == 1e-12
    assert all(bool(torch.isfinite(x).all()) for x in (sg.u, sg.u_old))
    # float32 Krylov on another device sums in another order: the step
    # error, and so the next dt, agree to f32-amplified rounding only
    assert abs(sg.dt - sc.dt) <= 1e-4 * sc.dt
    ug, uc = sg.u.cpu().numpy(), sc.u.numpy()
    for k in range(3):
        assert np.abs(ug[:, k] - uc[:, k]).max() <= 1e-6 * np.abs(
            uc[:, k]).max()


def test_kernel_runs_on_the_tensors_device(cuda):
    """Both forms of K1 on cuda:1 while cuda:0 is the current device: each
    launch must run on its tensors' device (and that device's stream)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda:1")
    flat, idx = _ell_case(3)
    rows, cidx, cflat, out = _compact_case(2, 3, 37)
    with torch.cuda.device(0):
        f = torch.as_tensor(flat, device=dev)
        i = torch.as_tensor(idx, dtype=torch.int32, device=dev)
        got = ell_scatter(f, i)
        o = torch.as_tensor(out, device=dev)
        r = torch.as_tensor(rows, dtype=torch.int32, device=dev)
        ci = torch.as_tensor(cidx, dtype=torch.int32, device=dev)
        cf = torch.as_tensor(cflat, device=dev)
        ref_add = ell_scatter_add_ref(o.clone(), cf, ci, r)
        ell_scatter_add_(o, cf, ci, r)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)
    assert got.device == dev and o.device == dev
    np.testing.assert_allclose(got.cpu().numpy(),
                               ell_scatter_ref(f, i).cpu().numpy(),
                               rtol=1e-13, atol=1e-13 * np.abs(flat).max())
    np.testing.assert_allclose(o.cpu().numpy(), ref_add.cpu().numpy(),
                               rtol=1e-13,
                               atol=1e-13 * np.abs(out).max())


def _window_model(device):
    cfg = StreamerConfig(z_corridor=(8.5e-3, 1e-2, 5e-5),
                         r_corridor=(2e-3, 2e-4), z_tail_cells=(12, 12),
                         mg_levels=3, density_floor=1e13,
                         poisson_precond="mg-zline")
    model = StreamerModel(cfg, device=device)
    model.system.use_gather_scatter()
    return model


def test_initial_state_and_move_window_on_cuda(cuda):
    """float64 on both devices: the initial Poisson solve and the remap
    agree to 1e-12 of each column's magnitude (summation order), and the
    residual on the moved mesh to 1e-12 per equation, at the moved state
    with noise added (at the solved potential the Poisson row cancels to
    1e-6 of its terms, and rounding shows at 1e-10 of what is left)."""
    gpu, cpu = _window_model(cuda), _window_model("cpu")
    sg, sc = gpu.initial_state(), cpu.initial_state()
    assert sg.u.device.type == "cuda" and sg.u.dtype == torch.float64

    def close(a, b, rtol=1e-12):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        for k in range(b.shape[1]):
            assert np.abs(a[:, k] - b[:, k]).max() <= \
                rtol * np.abs(b[:, k]).max(), k

    close(sg.u, sc.u)
    corr = (7.9e-3, 9.4e-3, 5e-5)
    before = launch_count("ell_scatter_add_")
    sg, sc = gpu.move_window(corr, sg), cpu.move_window(corr, sc)
    close(sg.u, sc.u)
    np.testing.assert_array_equal(gpu.mesh.coords, cpu.mesh.coords)
    p = StepParams(sg.t + sg.dt, sg.dt, sg.dt_old)
    noise = np.random.default_rng(0).standard_normal(sc.u.shape) * [
        1e-3, 1e-3, 10.0]
    u = sc.u + torch.as_tensor(noise)
    # the same inputs on both devices: the states agree to 1e-12 above
    Fg = gpu.system.residual(u.to(cuda), sc.u.to(cuda), sc.u_old.to(cuda), p)
    Fc = cpu.system.residual(u, sc.u, sc.u_old, p)
    close(Fg, Fc)
    assert launch_count("ell_scatter_add_") > before


def _glow_table():
    """The glow's cell ELL table: the crossed 64 x 64 mesh (8,321 rows x 8
    slots), and its cells' destination dofs."""
    from fedm_tpu_torch.fem.assembly import build_ell_index
    from fedm_tpu_torch.mesh import rectangle_mesh

    mesh = rectangle_mesh((0, 0), (0.01, 0.01), 64, 64, "crossed")
    return build_ell_index(mesh.cells, mesh.n_verts), mesh.cells.size


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [1, 5, 25])
def test_ell_dense_kernel_at_the_glow_shapes(cuda, C, dtype):
    """Both calls the glow makes on its cell table: `ell_scatter` (project,
    C = 1) and `ell_scatter_add_` with rows=None (residual and J v, C = 5;
    node blocks, C = 25), against their plain versions."""
    idx_np, n_flat = _glow_table()
    assert idx_np.shape == (8321, 8)
    flat = torch.as_tensor(np.random.default_rng(C).standard_normal(
        (n_flat, C)), dtype=dtype)
    idx = torch.as_tensor(idx_np)
    out0 = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (8321, C)), dtype=dtype)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    ref = ell_scatter_ref(flat, idx)
    got = ell_scatter(flat.to(cuda), idx.to(cuda)).cpu()
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    ref_add = ell_scatter_add_ref(out0.clone(), flat, idx)
    got_add = ell_scatter_add_(out0.to(cuda), flat.to(cuda), idx.to(cuda))
    torch.testing.assert_close(got_add.cpu(), ref_add, rtol=tol, atol=tol)


def _glow_model(device, tree, dtype=torch.float64):
    from fedm_tpu_torch.models.glow import GlowConfig, GlowDischargeModel

    model = GlowDischargeModel(GlowConfig(file_input=tree, nx=16, ny=16,
                                          dtype=dtype), device=device)
    model.system.use_gather_scatter()
    return model


def test_glow_residual_on_cuda(cuda, tmp_path):
    """The glow's float64 residual (cell scatter through K1's dense form)
    and its Jacobian action on the card against the same model on the CPU,
    at a seeded state with its own coefficients."""
    from fedm_tpu_torch.models.argon_synth import generate_argon_input

    generate_argon_input(tmp_path)
    cpu, gpu = _glow_model("cpu", tmp_path), _glow_model(cuda, tmp_path)
    s = cpu.initial_state()
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.standard_normal(tuple(s.u.shape))
                            * np.array([1e-2, 1e-2, 1e-2, 1e-2, 1.0]))
    u_old = s.u + noise
    u = u_old + 0.1 * noise
    p = StepParams(2e-12, 1e-12, 8e-13)
    launches = launch_count("ell_scatter_add_")
    Fg = gpu.system.residual(u.to(cuda), u_old.to(cuda), u_old.to(cuda), p,
                             aux=gpu._update_aux(u_old.to(cuda)))
    Fc = cpu.system.residual(u, u_old, u_old, p, aux=cpu._update_aux(u_old))
    assert launch_count("ell_scatter_add_") > launches
    for k in range(5):
        scale = float(Fc[:, k].abs().max())
        assert float((Fg[:, k].cpu() - Fc[:, k]).abs().max()) <= \
            1e-12 * scale, k
    v = torch.as_tensor(rng.standard_normal(tuple(u.shape)))
    ops_c = cpu.system.operators(u_old, u_old, p,
                                 aux=cpu._update_aux(u_old))
    ops_g = gpu.system.operators(u_old.to(cuda), u_old.to(cuda), p,
                                 aux=gpu._update_aux(u_old.to(cuda)))
    Jc = ops_c.jacobian_action(u - u_old)(v)
    Jg = ops_g.jacobian_action((u - u_old).to(cuda))(v.to(cuda)).cpu()
    for k in range(5):
        assert float((Jg[:, k] - Jc[:, k]).abs().max()) <= \
            1e-12 * float(Jc[:, k].abs().max()), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_invert_blocks_5x5_on_cuda(cuda, dtype):
    """The glow's 5 x 5 node blocks (Gauss-Jordan with partial pivoting)
    on the card against the CPU; blocks with rows of very different scales
    and one structurally singular block (the Jacobi fallback)."""
    from fedm_tpu_torch.solvers.precond import invert_blocks

    rng = np.random.default_rng(5)
    A = rng.standard_normal((8321, 5, 5)) + 10.0 * np.eye(5)
    A *= 10.0 ** rng.uniform(-20, 20, (8321, 5, 1))
    A[7, :, 4] = 0.0
    A = torch.as_tensor(A, dtype=dtype)
    got, n_got = invert_blocks(A.to(cuda), with_count=True)
    ref, n_ref = invert_blocks(A, with_count=True)
    assert n_got == n_ref == 1
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    scale = ref.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((got.cpu() - ref).abs() / scale).max()) <= tol


def test_direct_rescue_step_on_cuda(cuda):
    """One `DirectNewton` step on the card against the same step on the
    CPU (float32 probes, the float64 defect): K1's compact form runs in
    every probe, the iterations and colours are the same, and the states
    agree to float32 rounding."""
    from fedm_tpu_torch.solvers.direct import DirectNewton

    gpu, cpu = _small_model(cuda), _small_model("cpu")
    arrays = _uniform_state(cpu)
    p = StepParams(1e-12, 1e-12, 1e30)
    outs = []
    for model, dev in ((gpu, cuda), (cpu, "cpu")):
        s = state_from_arrays(arrays, device=dev)
        dn = DirectNewton(model.system, rtol=1e-3)
        before = launch_count("ell_scatter_add_")
        u, info = dn.step(s.u, s.u, s.u_old1, {}, p)
        assert info.converged and dn.n_factorizations >= 1
        if dev != "cpu":
            assert launch_count("ell_scatter_add_") - before >= dn.n_probes
        outs.append((u.cpu().numpy(), info.iters, dn.n_colors))
    (ug, kg, cg), (uc, kc, cc) = outs
    assert (kg, cg) == (kc, cc)
    # float32 probes rounded on two devices: the fields to 1e-6 of their
    # magnitude
    for k in range(3):
        assert np.abs(ug[:, k] - uc[:, k]).max() <= 1e-6 * np.abs(
            uc[:, k]).max(), k


@pytest.mark.parametrize("option", [
    dict(poisson_precond="mg"), dict(poisson_precond="zline"),
    dict(poisson_precond="mg-zline", transport_zline=True),
    dict(poisson_precond="mg-zline", row_scaled=True)],
    ids=["mg", "zline", "tzline", "row-scaled"])
def test_option_step_on_cuda(cuda, option):
    """One float64 advance with each Poisson-row and transport option on
    the card against the CPU: the same counts, dt and fields to 1e-8."""
    cfg = dict(nx=16, ny=24, density_floor=1e13, **option)
    outs = []
    for dev in (cuda, "cpu"):
        model = StreamerModel(StreamerConfig(**cfg), device=dev)
        model.system.use_gather_scatter()
        s = model.initial_state()
        s.dt = 1e-12
        s = model.make_driver().advance(s)
        outs.append((s.n_accepted, s.n_rejected, s.dt, s.u.cpu().numpy()))
    (ag, rg, dg, ug), (ac, rc, dc, uc) = outs
    assert (ag, rg) == (ac, rc) and ag == 1
    assert abs(dg - dc) <= 1e-8 * dc
    for k in range(3):
        assert np.abs(ug[:, k] - uc[:, k]).max() <= 1e-8 * np.abs(
            uc[:, k]).max()


def _tof_table(which):
    """The ToF cell ELL tables: 1D P2 on 4,000 cells (8,001 rows x 2
    slots), 2D P1 on 40 x 40 (1,681 x 6); and the flat row count."""
    from fedm_tpu_torch.fem import FunctionSpace
    from fedm_tpu_torch.fem.assembly import build_ell_index
    from fedm_tpu_torch.mesh import interval_mesh, rectangle_mesh

    space = (FunctionSpace(interval_mesh(4000, 0.0, 1e-3), 2)
             if which == "1d" else FunctionSpace(
                 rectangle_mesh((0, 0), (2.5e-4, 5e-4), 40, 40), 1))
    return build_ell_index(space.cell_dofs, space.n_dofs), \
        space.cell_dofs.size


@pytest.mark.parametrize("which,shape", [("1d", (8001, 2)),
                                         ("2d", (1681, 6))])
def test_ell_dense_kernel_at_the_tof_shapes(cuda, which, shape):
    """Both dense calls a ToF run makes on its cell table, float64, C = 1:
    `ell_scatter` (project) and `ell_scatter_add_` with rows=None
    (residual, J v, node blocks), against their plain versions."""
    idx_np, n_flat = _tof_table(which)
    assert idx_np.shape == shape
    rng = np.random.default_rng(shape[0])
    flat = torch.as_tensor(rng.standard_normal((n_flat, 1)))
    out0 = torch.as_tensor(rng.standard_normal((shape[0], 1)))
    idx = torch.as_tensor(idx_np)
    ref = ell_scatter_ref(flat, idx)
    got = ell_scatter(flat.to(cuda), idx.to(cuda)).cpu()
    torch.testing.assert_close(got, ref, rtol=1e-13, atol=1e-13)
    ref_add = ell_scatter_add_ref(out0.clone(), flat, idx)
    got_add = ell_scatter_add_(out0.to(cuda), flat.to(cuda), idx.to(cuda))
    torch.testing.assert_close(got_add.cpu(), ref_add, rtol=1e-13,
                               atol=1e-13)


def test_tof_1d_short_run_on_cuda(cuda):
    """A short 1D ToF run (100 P2 cells, 5 steps) on the card against the
    same run on the CPU: the same Newton iterations, states to 1e-11 and
    the error to 1e-11 relative, with K1's dense forms launched."""
    from fedm_tpu_torch.models.tof import TimeOfFlight1D, TofConfig

    def run(device):
        m = TimeOfFlight1D(TofConfig(dt=1e-11, T_final=5e-11), n_cells=100,
                           device=device)
        u, errors = m.run()
        return m, u.cpu().numpy(), errors

    before = (launch_count("ell_scatter"), launch_count("ell_scatter_add_"))
    mg, ug, eg = run(cuda)
    assert launch_count("ell_scatter") > before[0]
    assert launch_count("ell_scatter_add_") > before[1]
    mc, uc, ec = run("cpu")
    assert [i.iters for i in mg.step_infos] == [i.iters for i in
                                                  mc.step_infos]
    assert np.linalg.norm(ug - uc) <= 1e-11 * np.linalg.norm(uc)
    assert eg[0][0] == ec[0][0]
    assert abs(eg[0][1] - ec[0][1]) <= 1e-11 * ec[0][1]


def _extended_dd(device, tmp_path, nx=8, ny=16, n_parts=8):
    """The extended scheme (18 species) on a small crossed mesh, and the
    same model distributed over `n_parts` parts on `device`."""
    from fedm_tpu_torch.examples import extended_scheme
    from fedm_tpu_torch.models.argon_synth import generate_argon_n_input

    root = generate_argon_n_input(tmp_path, n_excited=13)
    args = extended_scheme.parse_args(["--device", str(device), "--nx",
                                       str(nx), "--ny", str(ny)])
    m = extended_scheme.build_model(args, tmp_path, root.name)
    md = extended_scheme.build_model(args, tmp_path, root.name)
    return m, md, md.distribute([device] * n_parts)


@pytest.mark.parametrize("C", [19, 361])
def test_ell_dense_kernel_at_the_dd_cell_table(cuda, tmp_path, C):
    """The domain decomposition's stacked cell table (8 parts, trash rows
    included), in place, float64, at the residual's C = 19 and the node
    blocks' C = 361, against the plain version."""
    _, _, d = _extended_dd("cpu", tmp_path)
    b = d._batches[0][0]
    assert b.gather_idx.shape[0] == d.n_parts * d.n_ext
    rng = np.random.default_rng(C)
    flat = torch.as_tensor(rng.standard_normal((b.dofs.numel(), C)))
    out0 = torch.as_tensor(rng.standard_normal((b.gather_idx.shape[0], C)))
    ref = ell_scatter_add_ref(out0.clone(), flat, b.gather_idx)
    got = ell_scatter_add_(out0.to(cuda), flat.to(cuda),
                           b.gather_idx.to(cuda))
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-13, atol=1e-13)


def test_distributed_residual_on_cuda(cuda, tmp_path):
    """The extended scheme's float64 residual and node blocks, 8 parts on
    the card, against the undistributed model on the CPU (rtol 1e-10, atol
    1e-12 of the largest entry), with K1's dense in-place form launched at
    C = 19 and C = 361; phantom rows stay identity rows."""
    m, _, _ = _extended_dd("cpu", tmp_path / "cpu")
    _, mg, dg = _extended_dd(cuda, tmp_path / "gpu")
    s, sg = m.initial_state(), mg.initial_state()
    p = StepParams(s.t + s.dt, s.dt, s.dt_old)
    aux, auxg = m._update_aux(s.u), mg._update_aux(sg.u)
    launches = launch_count("ell_scatter_add_")
    F = m.system.residual(s.u, s.u, s.u_old1, p, aux=aux)
    Fg = dg.residual(sg.u, sg.u, sg.u_old1, p, aux=auxg)
    B = m.system.operators(s.u, s.u_old1, p, aux=aux).jacobian_blocks(
        torch.zeros_like(s.u))
    Bg = dg.operators(sg.u, sg.u_old1, p, aux=auxg).jacobian_blocks(
        torch.zeros_like(sg.u))
    assert launch_count("ell_scatter_add_") >= launches + 2
    for got, ref in ((dg.from_dist(Fg), F.numpy()),
                     (dg.from_dist(Bg), B.numpy())):
        np.testing.assert_allclose(got, ref, rtol=1e-10,
                                   atol=1e-12 * np.abs(ref).max())
    phantom = np.setdiff1d(np.arange(dg.n_dofs_dist), dg._slot_of)
    assert not Fg[phantom].any()
    assert torch.equal(Bg[phantom].cpu(), torch.eye(19, dtype=Bg.dtype)
                       .expand(len(phantom), 19, 19))


@pytest.mark.parametrize("max_val, C", [(6, 1), (6, 19), (6, 361), (7, 1)])
def test_empty_kernel_launches_at_every_width(cuda, max_val, C):
    """The empty kernel (the floor chip_smoke.py times) launches on the
    grid of a call at (max_val, C), chosen by the real call's own switch:
    the templated kernel's at C = 1, the generic kernel's at a C or a
    valence without an instantiation."""
    from fedm_tpu_torch.ops.ell_scatter import ell_noop

    ell_noop(4696, max_val, C)
    torch.cuda.synchronize()


# -- deterministic segment sums; the batched sweep ----------------------------


def test_vcycle_is_bitwise_deterministic(cuda, tmp_path):
    """The glow's Poisson V-cycle (unstructured levels summed by K1's dense
    form, P1 restriction through its transposed table) applied twice to
    one vector gives the same bits, and matches the CPU's V-cycle."""
    from fedm_tpu_torch.models.argon_synth import generate_argon_input

    generate_argon_input(tmp_path)
    cpu, gpu = _glow_model("cpu", tmp_path), _glow_model(cuda, tmp_path)
    solve_c, solve_g = cpu.system._ell[1], gpu.system._ell[1]
    n = cpu.space.n_dofs
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(n),
                        dtype=cpu.batch.dtype)
    launches = launch_count("ell_scatter")
    a, b = solve_g(r.to(cuda)), solve_g(r.to(cuda))
    assert launch_count("ell_scatter") > launches
    assert torch.equal(a, b)
    ref = solve_c(r)
    assert float((a.cpu() - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())


def _small_sweep(device, amps=(2e18, 5e18, 1e19)):
    from fedm_tpu_torch.parallel import BatchedSweep

    cfg = StreamerConfig(nx=10, ny=14)
    model = StreamerModel(cfg, device=device)
    sweep = BatchedSweep(model.system, monitor_idx=1, ttol=cfg.ttol,
                         dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    states = [StreamerModel(StreamerConfig(nx=10, ny=14, seed_amplitude=a),
                            device=device).initial_state() for a in amps]
    return model, sweep, sweep.from_states(states)


def test_deterministic_mode_glow_advance_and_sweep_attempt(cuda, tmp_path):
    """One glow advance and one sweep attempt under
    `torch.use_deterministic_algorithms(True)` (no warn_only): every op on
    those paths has a deterministic CUDA form, or this raises. Each run
    twice gives the same bits."""
    from fedm_tpu_torch.models.argon_synth import generate_argon_input

    generate_argon_input(tmp_path)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        m = _glow_model(cuda, tmp_path)
        s = m.initial_state()
        d = m.make_driver()
        a = d.advance(s, m._update_aux(s.u))
        b = m.make_driver().advance(s, m._update_aux(s.u))
        assert torch.equal(a.u, b.u) and a.dt == b.dt
        _, sweep, st = _small_sweep(cuda)
        x, y = sweep.attempt(st, {}), sweep.attempt(st, {})
        assert (x.n_accepted == 1).all()
        assert torch.equal(x.u, y.u) and (x.max_error == y.max_error).all()
    finally:
        torch.use_deterministic_algorithms(was)


def test_sweep_attempt_on_cuda_matches_the_cpu(cuda):
    """One attempt of the batched sweep (3 members) on the card against the
    same on the CPU: the same counts, dt and step errors to 1e-10, the
    states to 1e-10 of each column's max."""
    _, sw_c, st_c = _small_sweep("cpu")
    _, sw_g, st_g = _small_sweep(cuda)
    a, b = sw_c.attempt(st_c, {}), sw_g.attempt(st_g, {})
    assert (a.n_accepted == b.n_accepted).all()
    np.testing.assert_allclose(b.dt, a.dt, rtol=1e-10)
    np.testing.assert_allclose(b.max_error, a.max_error, rtol=1e-10)
    scale = a.u.abs().amax(dim=1, keepdim=True)
    assert float(((b.u.cpu() - a.u).abs() / scale).max()) <= 1e-10


def test_k1_launches_per_batched_krylov_iteration_do_not_grow_with_b(cuda):
    """One BiCGStab iteration's operator and preconditioner applications
    (2 J v, 2 M) launch K1 as often for 1 member as for 4."""
    from fedm_tpu_torch.model.system import BatchedSystem
    from fedm_tpu_torch.ops.ell_scatter import LAUNCHES

    model = StreamerModel(StreamerConfig(nx=10, ny=14), device=cuda)
    s = model.initial_state()
    counts = []
    for B in (1, 4):
        bs = BatchedSystem(model.system, B)
        u = s.u.expand(B, -1, -1).contiguous()
        p = StepParams(*(np.full(B, x) for x in (s.dt, s.dt, s.dt_old)))
        ops = bs.operators(u, u, p)
        delta = torch.zeros((B * s.u.shape[0], 3), dtype=torch.float64,
                            device=cuda)
        J, M = ops.jacobian_action(delta), bs.block_precond_builder(ops)(
            delta)
        v = torch.ones_like(delta)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        for _ in range(2):
            v = M(J(v))
        counts.append(launch_count())
    assert counts[0] == counts[1] > 0
