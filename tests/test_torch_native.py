"""The port's native components and mesh graphs against the JAX package's,
on the CPU: the RCM ordering and the greedy partitioner (1, 4 and 8 parts)
of the dual graphs of crossed 7 x 9, 12 x 16, 10 x 10 and 32 x 64 meshes
equal, element for element, native against native and the scipy/RCM-slab
fallbacks against the JAX package's fallbacks (each package's build is
switched off the way `tests/unit/test_native.py` does it); the vertex and
cell adjacency graphs and `rcm_reorder` equal; the DOLFIN XML writer's
file byte for byte the JAX writer's, and each reader reads the other's
file."""

import contextlib

import numpy as np
import pytest

import fedm_tpu  # noqa: F401
from fedm_tpu import native as jax_native
from fedm_tpu.mesh import rectangle_mesh as jax_rectangle_mesh
from fedm_tpu.mesh import interval_mesh as jax_interval_mesh
from fedm_tpu.mesh import io_xml as jax_io_xml
from fedm_tpu.mesh import reorder as jax_reorder
from fedm_tpu_torch import native
from fedm_tpu_torch.mesh import interval_mesh, io_xml, rectangle_mesh, reorder

SIZES = [(7, 9), (12, 16), (10, 10), (32, 64)]


def _meshes(nx, ny, diagonal="crossed"):
    return (jax_rectangle_mesh((0, 0), (1e-2, 2e-2), nx, ny, diagonal),
            rectangle_mesh((0, 0), (1e-2, 2e-2), nx, ny, diagonal))


@contextlib.contextmanager
def _fallbacks():
    """Both packages on their numpy/scipy fallbacks."""
    saved = [(m, m._lib, m._build_failed) for m in (jax_native, native)]
    try:
        for m, _, _ in saved:
            m._lib, m._build_failed = None, True
        yield
    finally:
        for m, lib, failed in saved:
            m._lib, m._build_failed = lib, failed


def test_both_native_libraries_build():
    assert jax_native.native_available() and native.native_available()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dual_graph_equal(size):
    jm, tm = _meshes(*size)
    for a, b in zip(jax_reorder.cell_adjacency_csr(jm),
                    reorder.cell_adjacency_csr(tm)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fallback", [False, True],
                         ids=["native", "fallback"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rcm_order_equal(size, fallback):
    csr = reorder.cell_adjacency_csr(_meshes(*size)[1])
    with _fallbacks() if fallback else contextlib.nullcontext():
        ref = jax_native.rcm_order(*csr)
        got = native.rcm_order(*csr)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert sorted(got.tolist()) == list(range(len(csr[0]) - 1))


@pytest.mark.parametrize("fallback", [False, True],
                         ids=["native", "fallback"])
@pytest.mark.parametrize("n_parts", [1, 4, 8])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_partition_equal(size, n_parts, fallback):
    csr = reorder.cell_adjacency_csr(_meshes(*size)[1])
    with _fallbacks() if fallback else contextlib.nullcontext():
        ref = jax_native.partition_graph(*csr, n_parts)
        got = native.partition_graph(*csr, n_parts)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    sizes = np.bincount(got, minlength=n_parts)
    assert sizes.max() - sizes.min() <= 1 and len(sizes) == n_parts


def test_native_and_fallback_partitions_differ():
    """The check above can tell the two branches apart: on the 32 x 64 dual
    graph the gain-driven growth and the RCM slabs give other parts."""
    csr = reorder.cell_adjacency_csr(_meshes(32, 64)[1])
    grown = native.partition_graph(*csr, 8)
    with _fallbacks():
        slabs = native.partition_graph(*csr, 8)
    assert not np.array_equal(grown, slabs)


def test_partition_rejects_a_broken_csr():
    with pytest.raises(ValueError):
        native.partition_graph(np.array([0, 1, 2], np.int32),
                               np.array([1, 5], np.int32), 2)


@pytest.mark.parametrize("diagonal", ["right", "crossed"])
def test_vertex_adjacency_and_rcm_reorder_equal(diagonal):
    jm, tm = _meshes(12, 16, diagonal)
    for a, b in zip(jax_reorder.vertex_adjacency_csr(jm),
                    reorder.vertex_adjacency_csr(tm)):
        np.testing.assert_array_equal(a, b)
    jr, jperm = jax_reorder.rcm_reorder(jm)
    tr, tperm = reorder.rcm_reorder(tm)
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tr.cells, jr.cells)
    np.testing.assert_array_equal(tr.coords, jr.coords)


def test_interval_graphs_equal():
    jm, tm = jax_interval_mesh(10, 0, 1), interval_mesh(10, 0, 1)
    for fn in ("vertex_adjacency_csr", "cell_adjacency_csr"):
        for a, b in zip(getattr(jax_reorder, fn)(jm),
                        getattr(reorder, fn)(tm)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["triangle", "interval"])
def test_dolfin_xml_round_trip_matches_the_jax_writer(tmp_path, kind):
    if kind == "triangle":
        jm, tm = _meshes(5, 7, "crossed")
    else:
        jm, tm = (jax_interval_mesh(13, 0.0, 1e-3),
                  interval_mesh(13, 0.0, 1e-3))
    jax_io_xml.write_dolfin_xml(tmp_path / "jax.xml", jm)
    io_xml.write_dolfin_xml(tmp_path / "port.xml", tm)
    assert ((tmp_path / "port.xml").read_bytes()
            == (tmp_path / "jax.xml").read_bytes())
    back = io_xml.read_dolfin_xml(tmp_path / "jax.xml")
    np.testing.assert_array_equal(back.coords, tm.coords)
    np.testing.assert_array_equal(back.cells, tm.cells)
    jback = jax_io_xml.read_dolfin_xml(tmp_path / "port.xml")
    np.testing.assert_array_equal(jback.coords, jm.coords)
    np.testing.assert_array_equal(jback.cells, jm.cells)
    # a round trip through the port's own reader and writer is exact
    io_xml.write_dolfin_xml(tmp_path / "again.xml", back)
    assert ((tmp_path / "again.xml").read_bytes()
            == (tmp_path / "port.xml").read_bytes())


def test_dolfin_xml_reader_refuses_other_files(tmp_path):
    p = tmp_path / "x.xml"
    p.write_text('<?xml version="1.0"?>\n<other />\n')
    with pytest.raises(ValueError):
        io_xml.read_dolfin_xml(p)
    p.write_text('<dolfin><mesh celltype="tetrahedron" dim="3"/></dolfin>')
    with pytest.raises(ValueError):
        io_xml.read_dolfin_xml(p)
