"""The port's output stack against the JAX package's: VTU snapshots (ascii
and binary) and PVD collections, every `log` type and `mesh_statistics`
byte for byte for the same inputs; the XDMF/HDF5 checkpoint layout read
back as the reference's tests read it; `file_output`'s interpolation and
cadence; the `Files` singleton; and the utilities under `utils/`."""

import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.io import convenience as jconv
from fedm_tpu.io import logging as jlogging
from fedm_tpu.io import output as joutput
from fedm_tpu.io import vtu as jvtu
from fedm_tpu.io import xdmf as jxdmf
from fedm_tpu.mesh import interval_mesh as jinterval
from fedm_tpu.mesh import rectangle_mesh as jrect
from fedm_tpu.utils import comma_separated as jcomma
from fedm_tpu_torch.io import (Files, OutputSeries, VtuSeriesWriter,
                               XdmfH5Writer, file_output, files, log,
                               mesh_statistics, output_files,
                               read_checkpoints, read_vtu, write_vtu)
from fedm_tpu_torch.mesh import interval_mesh, rectangle_mesh
from fedm_tpu_torch.utils import (PhaseTimer, comma_separated,
                                  print_process_0, trace_annotation)

MESHES = {
    "interval": (lambda: jinterval(7, 0.0, 1e-3),
                 lambda: interval_mesh(7, 0.0, 1e-3)),
    "triangle": (lambda: jrect((0, 0), (2.5e-4, 5e-4), 3, 4),
                 lambda: rectangle_mesh((0, 0), (2.5e-4, 5e-4), 3, 4)),
    "crossed": (lambda: jrect((0, 0), (1, 1), 2, 2, "crossed"),
                lambda: rectangle_mesh((0, 0), (1, 1), 2, 2, "crossed")),
}


def _values(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.exp(rng.standard_normal(n) * 20.0) * rng.choice([-1, 1], n)


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
@pytest.mark.parametrize("point_dtype", [None, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_write_vtu_is_byte_identical(tmp_path, mesh, binary, point_dtype):
    jm, tm = (make() for make in MESHES[mesh])
    vals = _values(tm.n_verts)
    data = {"electrons": vals, "analytical solution": vals[::-1].copy()}
    jvtu.write_vtu(tmp_path / "j.vtu", jm, data, binary=binary,
                   point_dtype=point_dtype)
    # the port also takes tensors
    write_vtu(tmp_path / "t.vtu", tm,
              {k: torch.as_tensor(v) for k, v in data.items()},
              binary=binary, point_dtype=point_dtype)
    assert (tmp_path / "t.vtu").read_bytes() == \
        (tmp_path / "j.vtu").read_bytes()
    got = read_vtu(tmp_path / "t.vtu", "electrons")
    np.testing.assert_array_equal(got, jvtu.read_vtu(tmp_path / "j.vtu",
                                                     "electrons"))
    # ascii writes 16 significant digits: within an ulp of float64
    np.testing.assert_allclose(got, vals, rtol=1e-7 if point_dtype else (
        0 if binary else 1e-15))


def test_read_vtu_missing_field(tmp_path):
    write_vtu(tmp_path / "a.vtu", interval_mesh(2, 0, 1), {})
    with pytest.raises(KeyError):
        read_vtu(tmp_path / "a.vtu", "nothing")


def test_vtu_point_dtype_refused(tmp_path):
    with pytest.raises(ValueError, match="point_dtype"):
        write_vtu(tmp_path / "a.vtu", interval_mesh(2, 0, 1),
                  {"x": np.zeros(3)}, point_dtype=np.int32)


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_vtu_series_and_pvd_are_byte_identical(tmp_path, binary):
    jm, tm = (make() for make in MESHES["interval"])
    jw = jvtu.VtuSeriesWriter("electrons", tmp_path / "j", binary=binary)
    tw = VtuSeriesWriter("electrons", tmp_path / "t", binary=binary)
    for k in range(3):
        v = _values(tm.n_verts, k)
        jw.write(jm, v, k * 1e-9)
        tw.write(tm, torch.as_tensor(v), k * 1e-9,
                 field_name=None if k else "electrons")
    jd, td = tmp_path / "j" / "electrons", tmp_path / "t" / "electrons"
    assert sorted(p.name for p in td.iterdir()) == sorted(
        p.name for p in jd.iterdir()) == [
        "electrons.pvd", "electrons000000.vtu", "electrons000001.vtu",
        "electrons000002.vtu"]
    for p in jd.iterdir():
        assert (td / p.name).read_bytes() == p.read_bytes(), p.name


_LOGS = [
    ("properties", ("Air", "Time_of_flight",
                    ["electrons", "analytical solution"], 9.10938356e-31,
                    -1.6021766208e-19)),
    ("conditions", (1e-11, "None", 760.0, 1e-3, 760.0 * 3.21877e22,
                    300.0)),
    ("matrices", (np.arange(6).reshape(2, 3), np.eye(3) * 0.5,
                  np.array([[1.5e-3, 2.0], [3.0, 4e5]]))),
    ("initial time", (2.5e-9,)),
    ("time", (1.25e-10,)),
]


@pytest.mark.parametrize("kind,args", _LOGS, ids=[k for k, _ in _LOGS])
def test_log_is_byte_identical(tmp_path, kind, args):
    jlogging.log(kind, tmp_path / "j.log", *args)
    log(kind, tmp_path / "t.log", *args)
    log(kind, tmp_path / "t.log", *args)  # appends
    ref = (tmp_path / "j.log").read_text()
    assert (tmp_path / "t.log").read_text() == ref + ref


@pytest.mark.parametrize("mesh", list(MESHES))
def test_log_mesh_and_mesh_statistics(tmp_path, mesh, capsys):
    jm, tm = (make() for make in MESHES[mesh])
    jlogging.log("mesh", tmp_path / "j.log", jm)
    log("mesh", tmp_path / "t.log", tm)
    assert (tmp_path / "t.log").read_text() == \
        (tmp_path / "j.log").read_text()
    jinfo = jconv.mesh_statistics(jm, output_dir=tmp_path / "j")
    jout = capsys.readouterr().out
    info = mesh_statistics(tm, output_dir=tmp_path / "t")
    assert info == jinfo and capsys.readouterr().out == jout
    for name in ("mesh.vtu", "mesh info.txt"):
        assert (tmp_path / "t" / "mesh" / name).read_bytes() == \
            (tmp_path / "j" / "mesh" / name).read_bytes()


def test_log_refuses_an_unknown_type(tmp_path):
    for fn in (jlogging.log, log):
        with pytest.raises(ValueError, match="not recognised"):
            fn("volume", tmp_path / "x.log", 1)


def test_xdmf_h5_layout_matches_the_reference_reader(tmp_path):
    """The h5 satisfies the reference's read pattern
    h5[key][subkey]['vector'], and the .xdmf index is the JAX package's."""
    import h5py

    for mesh in ("interval", "triangle"):
        jm, tm = (make() for make in MESHES[mesh])
        jw = jxdmf.XdmfH5Writer("Ar_plus", tmp_path / "j" / mesh, mesh=jm)
        tw = XdmfH5Writer("Ar_plus", tmp_path / "t" / mesh, mesh=tm)
        for k in range(2):
            v = np.full(tm.n_verts, k + 1.0)
            jw.write_checkpoint(v, t=k * 0.1)
            tw.write_checkpoint(torch.as_tensor(v), t=k * 0.1)
        h5 = tmp_path / "t" / mesh / "Ar_plus" / "Ar_plus.h5"
        with h5py.File(h5) as f:
            vecs = [np.asarray(f["Ar_plus"][s]["vector"])
                    for s in f["Ar_plus"]]
            np.testing.assert_array_equal(f["mesh"]["coordinates"],
                                          tm.coords)
            np.testing.assert_array_equal(f["mesh"]["topology"], tm.cells)
            assert f["Ar_plus"]["Ar_plus_1"].attrs["timestamp"] == 0.1
        assert len(vecs) == 2
        got = read_checkpoints(h5, "Ar_plus")
        ref = jxdmf.read_checkpoints(
            tmp_path / "j" / mesh / "Ar_plus" / "Ar_plus.h5", "Ar_plus")
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        xdmf = "Ar_plus/Ar_plus.xdmf"
        assert (tmp_path / "t" / mesh / xdmf).read_text() == \
            (tmp_path / "j" / mesh / xdmf).read_text()


def test_xdmf_without_h5py_raises_import_error(tmp_path, monkeypatch):
    """Where h5py is missing the writer raises, and writes nothing else."""
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        XdmfH5Writer("n", tmp_path, mesh=interval_mesh(2, 0, 1))
    with pytest.raises(ImportError):
        read_checkpoints(tmp_path / "n.h5", "n")
    assert not (tmp_path / "n").exists()


def _run_file_output(mod_output, writer, tmp_mesh, u_states, tensors):
    series = [mod_output.OutputSeries(writer, lambda u: u, kind="pvd",
                                      field_name="n")]
    t_out_list, step_list = [4e-9, 1e-8], [1e-9, 4e-9]
    t_out, step = 1e-9, 1e-9
    hist = []
    t_old, u_old = 0.0, u_states[0]
    for t, u in zip((2.5e-9, 1.05e-8, 1.2e-8), u_states[1:]):
        a, b = (torch.as_tensor(u), torch.as_tensor(u_old)) if tensors \
            else (u, u_old)
        t_out, step = mod_output.file_output(t, t_old, t_out, step,
                                             t_out_list, step_list, series,
                                             a, b, mesh=tmp_mesh, unit="ns")
        hist.append((t_out, step))
        t_old, u_old = t, u
    return hist


def test_file_output_interpolates_and_switches_cadence(tmp_path):
    jm, tm = (make() for make in MESHES["interval"])
    states = [np.full(tm.n_verts, v) for v in (0.0, 2.5, 6.0, 7.0)]
    jw = jvtu.VtuSeriesWriter("n", tmp_path / "j")
    tw = VtuSeriesWriter("n", tmp_path / "t")
    ref = _run_file_output(joutput, jw, jm, states, False)
    got = _run_file_output(__import__("fedm_tpu_torch.io.output",
                                      fromlist=["x"]), tw, tm, states, True)
    assert got == ref
    assert ref[0] == (pytest.approx(3e-9), 1e-9)
    assert ref[1][1] == 4e-9  # past 0.999 * 4e-9: the second cadence
    assert tw.snapshots == jw.snapshots
    assert [t for t, _ in tw.snapshots][:3] == pytest.approx([1.0, 2.0,
                                                              3.0])
    jd, td = tmp_path / "j" / "n", tmp_path / "t" / "n"
    for p in jd.iterdir():
        assert (td / p.name).read_bytes() == p.read_bytes(), p.name
    np.testing.assert_allclose(read_vtu(td / "n000000.vtu", "n"), 1.0)
    with pytest.raises(ValueError, match="unit"):
        file_output(1.0, 0.0, 0.5, 0.5, [1.0], [0.5], [], states[1],
                    states[0], unit="h")
    with pytest.raises(ValueError, match="file type"):
        file_output(0.9, 0.0, 0.5, 0.5, [1.0], [0.5],
                    [OutputSeries(None, lambda u: u, kind="csv")],
                    states[1], states[0])


def test_output_files_factory(tmp_path):
    tm = MESHES["triangle"][1]()
    pvd = output_files("pvd", "number density", ["e", "Ar+"],
                       output_dir=tmp_path)
    assert [w.dir for w in pvd] == [tmp_path / "number density" / "e",
                                    tmp_path / "number density" / "Ar+"]
    x = output_files("xdmf", "number density", ["e"], mesh=tm,
                     output_dir=tmp_path)
    assert x[0].h5_path == tmp_path / "number density" / "e" / "e.h5"
    with pytest.raises(ValueError, match="not valid"):
        output_files("csv", "x", ["e"], output_dir=tmp_path)


def test_files_singleton_semantics(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    f = Files()
    assert f.output_folder_path == tmp_path / "output"
    with pytest.raises(RuntimeError):
        f.file_input = tmp_path / "missing"
    f.file_input = tmp_path
    out = tmp_path / "out"
    f.output_folder_path = out
    assert out.is_dir()
    p = f.error_file  # truncated once per output folder, then appended
    assert p.name == "relative error.log" and p.read_text() == ""
    p.write_text("data")
    assert f.error_file.read_text() == "data"
    assert f.model_log.name == "model.log"
    f.output_folder_path = tmp_path / "other"
    assert f.error_file.read_text() == ""
    # the module's singleton is a Files, untouched by the above
    assert isinstance(files, Files) and files is not f


def test_utils(capsys):
    assert comma_separated(["e", "Ar+"]) == jcomma(["e", "Ar+"]) \
        == "'e', 'Ar+'"
    print_process_0("hello", 1)
    assert capsys.readouterr().out == "hello 1\n"
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("assembly", block_on=torch.zeros(2)):
            pass
    assert timer.counts["assembly"] == 2
    assert timer.report().startswith("assembly")
    with trace_annotation("tof step"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0


def test_trace_annotation_lets_the_body_exception_through():
    with pytest.raises(KeyError, match="inner"):
        with trace_annotation("failing"):
            raise KeyError("inner")
