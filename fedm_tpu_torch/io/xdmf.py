"""XDMF/HDF5 checkpoint-style output.

The JAX package's writer: the HDF5 layout of dolfin's
`XDMFFile.write_checkpoint` that the reference writes
(`fedm/file_io.py:594-600`) and its
regression tests read back as `h5[name][f"{name}_{i}"]["vector"]`
(`tests/integrated_tests/testing_utils.py:22-25`,
`test_glow_discharge.py:35-40`), plus a minimal .xdmf XML index so the
series opens in ParaView. `h5py` is imported when a writer or reader is
made, so the rest of the package needs no h5py; without it they raise
ImportError, and no other format is written in their place.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_XDMF_TEMPLATE = """<?xml version="1.0"?>
<Xdmf Version="3.0" xmlns:xi="http://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="{name}" GridType="Collection" CollectionType="Temporal">
{grids}
    </Grid>
  </Domain>
</Xdmf>
"""

_GRID_TEMPLATE = """      <Grid Name="{name}_{i}" GridType="Uniform">
        <Time Value="{t}" />
        <Topology NumberOfElements="{n_cells}" TopologyType="{topo}">
          <DataItem Dimensions="{n_cells} {nv}" Format="HDF">{h5}:/mesh/topology</DataItem>
        </Topology>
        <Geometry GeometryType="{geom}">
          <DataItem Dimensions="{n_pts} {dim}" Format="HDF">{h5}:/mesh/coordinates</DataItem>
        </Geometry>
        <Attribute Name="{name}" AttributeType="Scalar" Center="Node">
          <DataItem Dimensions="{n_pts} 1" Format="HDF">{h5}:/{name}/{name}_{i}/vector</DataItem>
        </Attribute>
      </Grid>"""


class XdmfH5Writer:
    """`<dir>/<name>/<name>.h5` (+ `.xdmf`) appending checkpoint series."""

    def __init__(self, name: str, directory, mesh=None):
        import h5py

        self.name = name
        self.dir = Path(directory) / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.h5_path = self.dir / f"{name}.h5"
        self.mesh = mesh
        self.times = []
        self._h5py = h5py
        with h5py.File(self.h5_path, "w") as h5:
            if mesh is not None:
                g = h5.create_group("mesh")
                g.create_dataset("coordinates", data=mesh.coords)
                g.create_dataset("topology", data=mesh.cells.astype(np.int64))

    def write_checkpoint(self, values, t: float) -> None:
        i = len(self.times)
        with self._h5py.File(self.h5_path, "a") as h5:
            grp = h5.require_group(self.name)
            sub = grp.create_group(f"{self.name}_{i}")
            if hasattr(values, "detach"):
                values = values.detach().cpu().numpy()
            sub.create_dataset("vector", data=np.asarray(values))
            sub.attrs["timestamp"] = t
        self.times.append(t)
        if self.mesh is not None:
            self._write_xdmf()

    def _write_xdmf(self) -> None:
        mesh = self.mesh
        topo = "Triangle" if mesh.dim == 2 else "Polyline"
        geom = "XY" if mesh.dim == 2 else "X"
        grids = "\n".join(
            _GRID_TEMPLATE.format(
                name=self.name, i=i, t=t, n_cells=mesh.n_cells,
                nv=mesh.cells.shape[1], n_pts=mesh.n_verts, dim=mesh.dim,
                topo=topo, geom=geom, h5=self.h5_path.name)
            for i, t in enumerate(self.times)
        )
        (self.dir / f"{self.name}.xdmf").write_text(
            _XDMF_TEMPLATE.format(name=self.name, grids=grids))


def read_checkpoints(path, name: str):
    """All snapshots `[n_snapshots][n_dofs]` of a series, ordered, matching
    the reference tests' `read_h5` access pattern."""
    import h5py

    with h5py.File(path, "r") as h5:
        grp = h5[name]
        keys = sorted(grp.keys(), key=lambda k: int(k.rsplit("_", 1)[1]))
        return [np.asarray(grp[k]["vector"]) for k in keys]
