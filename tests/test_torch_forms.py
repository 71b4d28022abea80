"""The weak-form helpers of `model/forms.py` in the port against the JAX
package's, values and forward-mode tangents (`jax.jvp` against
`torch.autograd.forward_ad`), on a 1D P2 batch (the 1D time-of-flight
run's) and a 2D P1 triangle batch, with inputs made from a seed. float64
throughout, compared to 1e-13 relative (summation order of the einsums);
Min and Max at ties, and abs at 0, to their exact tangents."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import fedm_tpu  # noqa: F401
from fedm_tpu.fem import CellBatch as JCell
from fedm_tpu.fem import FacetBatch as JFacet
from fedm_tpu.fem import FunctionSpace as JSpace
from fedm_tpu.mesh import interval_mesh as jinterval
from fedm_tpu.mesh import rectangle_mesh as jrect
from fedm_tpu.model import forms as jforms
from fedm_tpu_torch.fem import CellBatch, FacetBatch, FunctionSpace
from fedm_tpu_torch.mesh import interval_mesh, rectangle_mesh
from fedm_tpu_torch.model import forms

RTOL = 1e-13


def _batches(kind):
    if kind == "interval-P2":
        js = JSpace(jinterval(6, 0.0, 1e-3), 2)
        ts = FunctionSpace(interval_mesh(6, 0.0, 1e-3), 2)
    else:
        js = JSpace(jrect((0, 0), (2.5e-4, 5e-4), 3, 4), 1)
        ts = FunctionSpace(rectangle_mesh((0, 0), (2.5e-4, 5e-4), 3, 4), 1)
    axi = kind != "interval-P2"
    return (JCell(js, quad_degree=6, axisymmetric=axi),
            CellBatch(ts, quad_degree=6, axisymmetric=axi, device="cpu"),
            JFacet(js, markers=None, quad_degree=4, axisymmetric=axi),
            FacetBatch(ts, markers=None, quad_degree=4, axisymmetric=axi,
                       device="cpu"))


@pytest.fixture(params=["interval-P2", "triangle-P1"])
def batches(request):
    return _batches(request.param)


def _close(got, ref, rtol=RTOL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _both(jfn, tfn, primals, tangents):
    """Values and tangents of jfn (JAX) and tfn (torch) at numpy inputs."""
    jv, jt = jax.jvp(jfn, tuple(jnp.asarray(p) for p in primals),
                     tuple(jnp.asarray(t) for t in tangents))
    with fwAD.dual_level():
        out = tfn(*(fwAD.make_dual(torch.as_tensor(p), torch.as_tensor(t))
                    for p, t in zip(primals, tangents)))
        tv, tt = fwAD.unpack_dual(out)
    return (tv, jv), (tt, jt)


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return shift + scale * rng.standard_normal(shape)


def test_bdf2_parts():
    rng = np.random.default_rng(0)
    u, u0, u1 = (_rand(rng, 5, 4) for _ in range(3))
    for dt, dt_old in ((1e-11, 1e30), (1e-12, 1e-12), (2e-12, 3e-12)):
        _close(forms.bdf2_history_part(*map(torch.as_tensor, (u, u0, u1)),
                                       dt, dt_old),
               jforms.bdf2_history_part(u, u0, u1, dt, dt_old), 1e-15)
        _close(forms.bdf2_increment_part(torch.as_tensor(u - u0),
                                         torch.as_tensor(u0 - u1),
                                         dt, dt_old),
               jforms.bdf2_increment_part(u - u0, u0 - u1, dt, dt_old),
               1e-15)


@pytest.mark.parametrize("grad_diffusion", [True, False])
@pytest.mark.parametrize("log_rep", [True, False], ids=["log", "linear"])
def test_drift_diffusion_flux(batches, grad_diffusion, log_rep):
    jb, tb = batches[:2]
    rng = np.random.default_rng(1)
    n, nl, q, dim = tb.dofs.shape[0], tb.n_local, tb.n_q, tb.dim
    u = _rand(rng, n, nl, shift=20.0)
    D = _rand(rng, n, nl, scale=0.01, shift=0.12)
    mu = _rand(rng, n, nl, scale=0.1, shift=1.0)
    E = _rand(rng, n, q, dim, scale=1e5)
    tan = _rand(rng, n, nl)

    def jfn(u_e):
        return jforms.drift_diffusion_flux(
            jb, u_e, jnp.asarray(D), jnp.asarray(mu), jnp.asarray(E), -1.0,
            grad_diffusion, log_rep)

    def tfn(u_e):
        return forms.drift_diffusion_flux(
            tb, u_e, torch.as_tensor(D), torch.as_tensor(mu),
            torch.as_tensor(E), -1.0, grad_diffusion, log_rep)

    for got, ref in _both(jfn, tfn, [u], [tan]):
        _close(got, ref)


@pytest.mark.parametrize("eq", ["reaction", "diffusion-reaction",
                                "drift-diffusion-reaction"])
@pytest.mark.parametrize("log_rep", [True, False], ids=["log", "linear"])
def test_balance_equation_contrib(batches, eq, log_rep):
    jb, tb = batches[:2]
    rng = np.random.default_rng(2)
    n, nl, q, dim = tb.dofs.shape[0], tb.n_local, tb.n_q, tb.dim
    u_old = _rand(rng, n, nl, shift=20.0)
    d_hist = _rand(rng, n, nl, scale=1e-3)
    delta = _rand(rng, n, nl, scale=1e-3)
    f = _rand(rng, n, q, scale=1e10)
    D = _rand(rng, n, nl, scale=0.01, shift=0.12)
    G = _rand(rng, n, q, dim, scale=1e12)
    tan = _rand(rng, 2, n, nl)
    dt, dt_old = 1e-12, 1.5e-12

    def jfn(dl, uo):
        return jforms.balance_equation_contrib(
            jb, eq, dl, uo, jnp.asarray(d_hist), dt, dt_old, jnp.asarray(f),
            Gamma_q=jnp.asarray(G), D_e=jnp.asarray(D),
            log_representation=log_rep)

    def tfn(dl, uo):
        return forms.balance_equation_contrib(
            tb, eq, dl, uo, torch.as_tensor(d_hist), dt, dt_old,
            torch.as_tensor(f), Gamma_q=torch.as_tensor(G),
            D_e=torch.as_tensor(D), log_representation=log_rep)

    for got, ref in _both(jfn, tfn, [delta, u_old], list(tan)):
        _close(got, ref)


def test_balance_equation_refusals(batches):
    jb, tb = batches[:2]
    z = torch.zeros((tb.dofs.shape[0], tb.n_local), dtype=torch.float64)
    fq = torch.zeros((tb.dofs.shape[0], tb.n_q), dtype=torch.float64)
    for eq, match in (("diffusion-reaction", "requires D_e"),
                      ("drift-diffusion-reaction", "requires Gamma_q"),
                      ("advection", "not recognised")):
        with pytest.raises(ValueError, match=match):
            forms.balance_equation_contrib(tb, eq, z, z, z, 1.0, 1.0, fq)


def test_poisson_contrib(batches):
    jb, tb = batches[:2]
    rng = np.random.default_rng(3)
    n, nl, q = tb.dofs.shape[0], tb.n_local, tb.n_q
    phi = _rand(rng, n, nl, scale=1e3)
    f = _rand(rng, n, q, scale=1e-2)
    tan = _rand(rng, n, nl)
    for got, ref in _both(
            lambda p: jforms.poisson_contrib(jb, p, jnp.asarray(f)),
            lambda p: forms.poisson_contrib(tb, p, torch.as_tensor(f)),
            [phi], [tan]):
        _close(got, ref)


@pytest.mark.parametrize("fn", ["Min", "Max"])
def test_min_max_values_and_tangents_at_ties(fn):
    a = np.array([1.0, 2.0, -3.0, 0.0, 5.0, -0.0])
    b = np.array([2.0, 2.0, -4.0, 0.0, 1.0, 0.0])  # ties at 1, 3, 5
    ta = np.array([1.0, 10.0, 1.0, 7.0, 1.0, 3.0])
    tb_ = np.array([5.0, 20.0, 5.0, 9.0, 5.0, 4.0])
    for got, ref in _both(getattr(jforms, fn), getattr(forms, fn), [a, b],
                          [ta, tb_]):
        _close(got, ref, 0)


_FLUX_CASES = [
    ("zero flux", "drift-diffusion-reaction", "electrons"),
    ("zero_flux", "reaction", "Heavy"),
    ("flux source", "reaction", "Heavy"),
    ("flux source", "diffusion-reaction", "Heavy"),
    ("flux source", "diffusion-reaction", "electrons"),
    ("flux source", "drift-diffusion-reaction", "Heavy"),
    ("flux source", "drift-diffusion-reaction", "electrons"),
    ("Neumann", "drift-diffusion-reaction", "electrons"),
    ("Neumann", "diffusion-reaction", "Heavy"),
]


@pytest.mark.parametrize("bc,eq,particle", _FLUX_CASES,
                         ids=[f"{b}-{e}-{p}" for b, e, p in _FLUX_CASES])
def test_boundary_flux(batches, bc, eq, particle):
    jf, tf = batches[2:]
    rng = np.random.default_rng(4)
    shape = (tf.n_facets, tf.n_q)
    mu = _rand(rng, *shape, scale=0.1, shift=1.0)
    En = _rand(rng, *shape, scale=1e5)
    En[0, 0] = 0.0  # |sign mu E.n| at 0: the JAX tangent of abs
    u = _rand(rng, *shape, shift=20.0)
    ion = _rand(rng, *shape, scale=1e18)
    vth = 1.2e5
    tan = _rand(rng, 3, *shape)
    kw = dict(gamma=0.05, r_coeff=0.2, vth=vth)

    def jfn(m, e, uu):
        return jforms.boundary_flux(jf, bc, eq, particle, -1.0, m, e, uu,
                                    Ion_flux=jnp.asarray(ion), **kw)

    def tfn(m, e, uu):
        out = forms.boundary_flux(tf, bc, eq, particle, -1.0, m, e, uu,
                                  Ion_flux=torch.as_tensor(ion), **kw)
        return out if isinstance(out, torch.Tensor) else torch.zeros(())

    if isinstance(jfn(*map(jnp.asarray, (mu, En, u))), float):
        assert forms.boundary_flux(tf, bc, eq, particle, -1.0, mu, En, u,
                                   **kw) == 0.0
        return
    for got, ref in _both(jfn, tfn, [mu, En, u], list(tan)):
        _close(got, ref)


@pytest.mark.parametrize("args,match", [
    (("Robin", "reaction", "Heavy"), "boundary condition type"),
    (("Neumann", "advection", "Heavy"), "equation type"),
    (("flux source", "diffusion-reaction", "ions"), "particle type"),
], ids=["bc", "equation", "particle"])
def test_boundary_flux_refusals(args, match):
    for mod in (jforms, forms):
        with pytest.raises(ValueError, match=match):
            mod.boundary_flux(None, *args, 1.0, 1.0, 1.0, 1.0, 0.1)
