"""The extended reaction scheme (18 species, 19 equations per node) of
`python -m fedm_tpu_torch.examples.extended_scheme` against the JAX
package's `examples/extended_scheme.py` on the CPU, on a crossed 8 x 8
mesh:

- the model's metadata equal (species and their names, equations,
  dofs, the reaction matrices' shape);
- three driver advances (the coefficient update before each) of the port
  distributed over 8 parts equal to its undistributed run and to the JAX
  package's single-device run: the accepted and rejected counts and each
  advance's Newton and BiCGStab counts equal, t and dt to 1e-10 relative,
  the state to rtol 1e-6, atol 1e-10 (the JAX DD test's step tolerances:
  Newton stops at rtol 1e-4 and the sums run in other orders; the port's
  J v applies element Jacobians, the JAX package's is a forward-mode pass);
- the entry point with `--device cpu --nx 8 --ny 8 --devices 4 --steps 1`
  prints the JAX example's lines with the JAX package's numbers (its
  partition into 4 parts from the JAX `DistributedSystem`'s host tables,
  the rest from the single-device run: the JAX example's own 4-part run
  would compile a shard_map); without a GPU it exits 1 unless given
  `--device cpu`.
"""

import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import fedm_tpu  # noqa: F401
from fedm_tpu.models.argon_synth import generate_argon_n_input as jax_generate
from fedm_tpu.models.generic import PlasmaConfig as JConfig
from fedm_tpu.models.generic import PlasmaModel as JModel
from fedm_tpu_torch.examples import extended_scheme
from fedm_tpu_torch.models.argon_synth import generate_argon_n_input
from fedm_tpu_torch.solvers import newton as port_newton

ROOT = Path(__file__).resolve().parent.parent
N, N_ADVANCES, N_PARTS = 8, 3, 8
STATE_RTOL, STATE_ATOL, TIME_RTOL = 1e-6, 1e-10, 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("argon_n")
    root = jax_generate(base, n_excited=13)
    return base, root.name


def _jax_model(tree, nx=N, ny=N):
    base, name = tree
    return JModel(JConfig(model=name, file_input=base, nx=nx, ny=ny,
                          mg_levels=0, quad_degree=2))


def _port_model(tree, nx=N, ny=N):
    args = extended_scheme.parse_args(["--device", "cpu", "--nx", str(nx),
                                       "--ny", str(ny)])
    return extended_scheme.build_model(args, *tree)


def _count(counts, name, fn):
    def run(*a, **kw):
        out = fn(*a, **kw)
        counts[name] = counts.get(name, 0) + (
            1 if name == "newton_iteration" else int(out[2]))
        return out
    return run


@pytest.fixture(scope="module")
def jax_run(tree):
    """The JAX package's single-device run: per advance (t, dt, accepted,
    rejected, Newton and BiCGStab counts, state)."""
    from fedm_tpu.solvers import newton

    counts = {}

    def bump(name):
        def add(k):
            counts[name] = counts.get(name, 0) + int(k)
        return add

    def counting(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            jax.debug.callback(bump(name), 1 if name == "newton_iteration"
                               else out[2])
            return out
        return run

    saved = {n: getattr(newton, n) for n in ("newton_iteration", "bicgstab")}
    for n, fn in saved.items():
        setattr(newton, n, counting(n, fn))
    try:
        m = _jax_model(tree)
        driver = m.make_driver()
        st = m.initial_state()
        rec = []
        for _ in range(N_ADVANCES):
            counts.clear()
            st = driver.advance(st, m._update_aux_jit(st.u))
            jax.block_until_ready(st.u)
            rec.append((st.t, st.dt, st.n_accepted, st.n_rejected,
                        dict(counts), np.asarray(st.u)))
    finally:
        for n, fn in saved.items():
            setattr(newton, n, fn)
    return m, rec


def _port_run(m, from_dist=None):
    counts = {}
    driver = m.make_driver()
    st = m.initial_state()
    rec = []
    saved = {n: getattr(port_newton, n) for n in ("newton_iteration",
                                                  "bicgstab")}
    for n, fn in saved.items():
        setattr(port_newton, n, _count(counts, n, fn))
    try:
        for _ in range(N_ADVANCES):
            counts.clear()
            st = driver.advance(st, m._update_aux(st.u))
            u = st.u.numpy() if from_dist is None else from_dist(st.u)
            rec.append((st.t, st.dt, st.n_accepted, st.n_rejected,
                        dict(counts), u))
    finally:
        for n, fn in saved.items():
            setattr(port_newton, n, fn)
    return rec


@pytest.fixture(scope="module")
def port_runs(tree):
    m = _port_model(tree)
    single = _port_run(m)
    md = _port_model(tree)
    d = md.distribute(["cpu"] * N_PARTS)
    dist = _port_run(md, d.from_dist)
    return single, dist


def test_metadata_matches_the_jax_model(tree):
    jm, tm = _jax_model(tree), _port_model(tree)
    assert (tm.n_species, tm.n_eq, tm.ie) == (18, 19, 17)
    assert (tm.n_species, tm.n_eq, tm.ie) == (jm.n_species, jm.n_eq, jm.ie)
    assert list(tm.species) == list(jm.species)
    assert tm.P_mat.shape == jm.P_mat.shape == (60, 18)
    np.testing.assert_array_equal(tm.P_mat, jm.P_mat)
    assert tm.space.n_dofs == jm.space.n_dofs == 145
    assert tm.equation_types == jm.equation_types


def _same_run(got, ref):
    for g, r in zip(got, ref):
        t, dt, acc, rej, counts, u = g
        np.testing.assert_allclose([t, dt], r[:2], rtol=TIME_RTOL, atol=0)
        assert (acc, rej, counts) == tuple(r[2:5])
        np.testing.assert_allclose(u, r[5], rtol=STATE_RTOL, atol=STATE_ATOL)


@pytest.mark.parametrize("which", ["undistributed", "8 parts"])
def test_advances_match_the_jax_single_device_run(jax_run, port_runs,
                                                   which):
    got = port_runs[0] if which == "undistributed" else port_runs[1]
    assert [r[2] for r in got] == [1, 2, 3]
    _same_run(got, jax_run[1])


def test_distributed_advances_match_the_undistributed(port_runs):
    _same_run(port_runs[1], port_runs[0])


def test_entry_point_prints_the_jax_example_lines(tree, jax_run):
    """--devices 4 --steps 1: two advances, the JAX example's lines."""
    jm, rec = jax_run
    jd = _jax_model(tree).distribute(Mesh(np.array(jax.devices()[:4]),
                                          ("space",)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        extended_scheme.main(["--device", "cpu", "--nx", "8", "--ny", "8",
                              "--devices", "4", "--steps", "1"])
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 5
    assert re.fullmatch(r"generated 18-species synthetic tree at \S+"
                        r"argon_synth18", lines[0])
    assert lines[1] == (
        f"{jm.n_species} species, {jm.n_eq} equations/node, "
        f"{jm.space.n_dofs} dofs = {jm.space.n_dofs * jm.n_eq} unknowns, "
        f"{jm.P_mat.shape[0]} reactions")
    assert lines[2] == (f"distributed over 4 devices: {jd.n_own_max} own "
                        f"+ {jd.n_ghost_max} ghost rows/dev")
    assert re.fullmatch(r"first step \(incl\. compile\): \d+\.\ds", lines[3])
    t, _, acc, rej, _, u = rec[1]
    ie = jm.ie
    tail = re.fullmatch(
        r"(.*) \((\d+) rejected\), \d+\.\d\d s/step, (.*)", lines[4])
    assert tail is not None, lines[4]
    assert tail[1] == f"{acc} accepted steps to t={t:.3e}"
    assert int(tail[2]) == rej
    assert tail[3] == (f"ne_max={np.exp(u[:, ie]).max():.3e} m^-3, "
                       f"eps_mean={np.exp(u[:, 0] - u[:, ie]).mean():.2f} "
                       f"eV, finite: True")


def test_entry_point_refuses_to_run_without_a_gpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "fedm_tpu_torch.examples.extended_scheme",
         "--nx", "4", "--ny", "4"], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=120)
    assert r.returncode == 1 and "--device cpu" in r.stderr
    assert r.stdout == ""
    h = subprocess.run(
        [sys.executable, "-m", "fedm_tpu_torch.examples.extended_scheme",
         "--help"], capture_output=True, text=True, cwd=tmp_path, env=env,
        timeout=120)
    assert h.returncode == 0 and "stacked" in h.stdout


def test_port_generator_writes_the_jax_tree(tmp_path):
    jb, pb = tmp_path / "jax", tmp_path / "port"
    jr = jax_generate(jb, n_excited=13)
    pr = generate_argon_n_input(pb, n_excited=13)
    files = sorted(p.relative_to(jr) for p in jr.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(pr) for p in pr.rglob("*")
                           if p.is_file())
    for f in files:
        assert (pr / f).read_bytes() == (jr / f).read_bytes(), f
