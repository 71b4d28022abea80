"""The port's chemistry front end against the JAX package on the synthetic
argon trees: the generated files byte for byte, the parsers' outputs
exactly, coefficient evaluation and derivative tables to 1e-13 relative
inside and outside the tables, the source terms to 1e-13, and `lut_interp`
against `jnp.interp` at the knots, between them and beyond both ends."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.chemistry import coefficients as jcoef
from fedm_tpu.chemistry import parsers as jpar
from fedm_tpu.chemistry import sources as jsrc
from fedm_tpu.models import argon_synth as jsynth
from fedm_tpu.ops.interp import lut_interp as jax_interp
from fedm_tpu_torch.chemistry import coefficients as tcoef
from fedm_tpu_torch.chemistry import parsers as tpar
from fedm_tpu_torch.chemistry import sources as tsrc
from fedm_tpu_torch.models import argon_synth as tsynth
from fedm_tpu_torch.ops.interp import lut_interp

RTOL = 1e-13
GENERATORS = {
    "argon_synth": ("generate_argon_input", {}),
    "argon_synth8": ("generate_argon8_input", {}),
    "argon_synth6": ("generate_argon_n_input", {"n_excited": 1}),
}
N0 = 3.21877e22


def _files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{model: (JAX package's tree, port's tree)} of every generator."""
    base = tmp_path_factory.mktemp("argon")
    out = {}
    for model, (fn, kw) in GENERATORS.items():
        roots = []
        for pkg, tag in ((jsynth, "jax"), (tsynth, "port")):
            roots.append(getattr(pkg, fn)(base / tag, model=model, **kw))
        out[model] = tuple(roots)
    return out


@pytest.mark.parametrize("model", sorted(GENERATORS))
def test_generated_trees_are_byte_identical(trees, model):
    jroot, troot = trees[model]
    assert _files(jroot) == _files(troot) and len(_files(jroot)) > 10
    for rel in _files(jroot):
        assert (jroot / rel).read_bytes() == (troot / rel).read_bytes(), rel


def _parsed(par, root: Path):
    """Every reader's output on one tree, as plain Python/numpy values."""
    base, model = root.parent, root.name
    n, names, props, tc = par.read_speclist(root)
    P, L, G = par.reaction_matrices(root, names)
    kfiles = par.rate_coefficient_file_names(root)
    deps = par.read_dependences(kfiles)
    kxs, kys = par.read_rate_coefficients(kfiles, deps)
    out = {"speclist": (n, names, props, tc), "P": P, "L": L, "G": G,
           "kfiles": [Path(k).relative_to(root) for k in kfiles],
           "deps": deps, "kx": kxs, "ky": kys,
           "u_loss": par.read_energy_loss(root),
           "props": par.read_particle_properties(props, model,
                                                 file_input=base)}
    for kind in ("mobility", "Diffusion"):
        out[kind] = par.read_transport_coefficients(tc, kind, model,
                                                    file_input=base)
    return out


def _assert_equal(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("model", sorted(GENERATORS))
def test_parsers_give_the_jax_package_outputs(trees, model):
    jroot, _ = trees[model]
    ref, got = _parsed(jpar, jroot), _parsed(tpar, jroot)
    assert ref.keys() == got.keys()
    for k in ref:
        _assert_equal(got[k], ref[k])


def test_readers_need_file_input(trees):
    jroot, _ = trees["argon_synth"]
    with pytest.raises(ValueError, match="file_input"):
        tpar.read_particle_properties(["electrons.cfg"], "argon_synth")


def _coefficient_sets(coef, root: Path):
    base, model = root.parent, root.name
    _, _, _, tc = jpar.read_speclist(root)
    rate = coef.RateCoefficients.read(jpar.rate_coefficient_file_names(root))
    mob = coef.TransportCoefficients.read(tc, "mobility", model,
                                          file_input=base)
    dif = coef.TransportCoefficients.read(tc, "Diffusion", model,
                                          file_input=base)
    return {"rate": rate, "mobility": mob, "Diffusion": dif}


# mean energies [eV] and reduced fields [Td] inside, at the ends of and
# beyond the generated tables (0.01-100 eV, 0.1-2000 Td)
ENERGY = np.concatenate([np.geomspace(1e-4, 1e3, 301), [0.01, 100.0, 3.0]])
FIELD = np.concatenate([np.geomspace(1e-3, 1e5, 301), [0.1, 2000.0, 0.0]])


def _close(got, ref, rtol=RTOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= rtol * scale


@pytest.mark.parametrize("kind", ["rate", "mobility", "Diffusion"])
@pytest.mark.parametrize("model", ["argon_synth", "argon_synth8"])
def test_coefficient_evaluate_and_table_gradient(trees, model, kind):
    jroot, _ = trees[model]
    jset = _coefficient_sets(jcoef, jroot)[kind]
    tset = _coefficient_sets(tcoef, jroot)[kind]
    assert jset.dependences == tset.dependences
    e_j, f_j = jnp.asarray(ENERGY), jnp.asarray(FIELD)
    e_t, f_t = torch.as_tensor(ENERGY), torch.as_tensor(FIELD)
    mu = np.full(ENERGY.shape, 7.5e-3)
    kw = dict(N0=N0, Tgas=300.0)
    for jc, tc in zip(jset, tset):
        ref = jc.evaluate(energy=e_j, redfield=f_j, mu=jnp.asarray(mu),
                          like=e_j, **kw)
        got = tc.evaluate(energy=e_t, redfield=f_t, mu=torch.as_tensor(mu),
                          like=e_t, **kw)
        assert got.dtype == torch.float64
        _close(got, ref)
        if jc.dependence == "Umean":
            jd, td = jc.table_gradient(), tc.table_gradient()
            _close(td.ky, jd.ky)
            _close(td.evaluate(energy=e_t, like=e_t, **kw),
                   jd.evaluate(energy=e_j, like=e_j, **kw))


def test_coefficient_evaluate_keeps_the_like_type_for_a_float32_field(trees):
    """The reduced field arrives in the batch's float32; the table lookup
    runs in float64 and the result takes `like`'s type."""
    jroot, _ = trees["argon_synth"]
    jmob = _coefficient_sets(jcoef, jroot)["mobility"]
    tmob = _coefficient_sets(tcoef, jroot)["mobility"]
    field = FIELD.astype(np.float32)
    like = np.ones(len(FIELD))
    ref = jmob[2].evaluate(N0=N0, redfield=jnp.asarray(field),
                           like=jnp.asarray(like))
    got = tmob[2].evaluate(N0=N0, redfield=torch.as_tensor(field),
                           like=torch.as_tensor(like))
    assert jmob[2].dependence == "E/N" and got.dtype == torch.float64
    _close(got, ref)


@pytest.mark.parametrize("model", ["argon_synth", "argon_synth8"])
def test_sources(trees, model):
    jroot, _ = trees[model]
    n, names, _, _ = jpar.read_speclist(jroot)
    P, L, G = jpar.reaction_matrices(jroot, names)
    u_loss = jpar.read_energy_loss(jroot) + [7.5e77, 9.5e99]
    rng = np.random.default_rng(3)
    shape = (17, 6)
    k = 10.0 ** rng.uniform(-20, -13, shape + (P.shape[0],))
    ln_n = np.concatenate([np.full(shape + (1,), np.log(N0)),
                           rng.uniform(25, 40, shape + (n - 1,))], axis=-1)
    eps = rng.uniform(0.5, 30.0, shape)
    rates_j = jsrc.reaction_rates(jnp.asarray(k), P, jnp.asarray(ln_n))
    rates_t = tsrc.reaction_rates(torch.as_tensor(k), P,
                                  torch.as_tensor(ln_n))
    _close(rates_t, rates_j)
    # the species sources: the model takes them as rates @ (G - L)
    _close(rates_t @ torch.as_tensor(G - L, dtype=torch.float64),
           jsrc.species_sources(rates_j, L, G))
    _close(tsrc.energy_source_factors(u_loss, torch.as_tensor(eps), 4.0),
           jsrc.energy_source_factors(u_loss, jnp.asarray(eps), 4.0))
    # the power matrix as a tensor already on the device, as the model
    # keeps it
    _close(tsrc.reaction_rates(
        torch.as_tensor(k), torch.as_tensor(P, dtype=torch.float64),
        torch.as_tensor(ln_n)), rates_j)


XP = np.geomspace(0.01, 100.0, 200)
# the knots themselves, between them, and beyond both ends
X_CASES = {
    "knots": XP,
    "between": np.sqrt(XP[1:] * XP[:-1]),
    "ends": np.array([-5.0, 0.0, 1e-3, 0.01, 100.0, 100.5, 1e6]),
}


@pytest.mark.parametrize("case", sorted(X_CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lut_interp_matches_jnp_interp(case, dtype):
    fp = np.cos(XP) * 1e-14 + 2e-14
    x = X_CASES[case].astype(dtype)
    ref = np.asarray(jax_interp(jnp.asarray(x), XP, fp))
    got = lut_interp(torch.as_tensor(x), torch.as_tensor(XP),
                     torch.as_tensor(fp)).numpy()
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    if case == "knots" and dtype == np.float64:
        np.testing.assert_array_equal(got, fp)
    if case == "ends":
        assert got[0] == fp[0] and got[-1] == fp[-1]


def test_lut_interp_with_repeated_knots():
    """A zero-width bracket takes its left value, as `jnp.interp` does."""
    xp = np.array([0.0, 1.0, 1.0, 2.0, 2.0, 2.0, 3.0])
    fp = np.array([0.0, 1.0, 5.0, 2.0, 7.0, 9.0, 4.0])
    x = np.array([-1.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 4.0])
    ref = np.asarray(jax_interp(jnp.asarray(x), xp, fp))
    got = lut_interp(torch.as_tensor(x), torch.as_tensor(xp),
                     torch.as_tensor(fp)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_lut_interp_of_a_scalar_and_a_matrix():
    fp = np.linspace(1.0, 2.0, len(XP))
    for x in (np.array(3.3), np.array([[0.02, 50.0], [1e3, 1e-3]])):
        ref = np.asarray(jax_interp(jnp.asarray(x), XP, fp))
        got = lut_interp(torch.as_tensor(x), torch.as_tensor(XP),
                         torch.as_tensor(fp)).numpy()
        assert got.shape == x.shape
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
