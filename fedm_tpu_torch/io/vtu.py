"""VTU/PVD output: VTK XML unstructured-grid files, byte for byte the JAX
package's.

The reference's dolfin `File('*.pvd') << (function, t)` output
(`fedm/file_io.py:148-188`): each write appends a
`<name>%06d.vtu` snapshot and re-emits the `.pvd` collection file indexing
all snapshots by timestep — the layout ParaView (and the reference's own
regression reader, `tests/integrated_tests/testing_utils.py:16-20`)
expects. A minimal reader is provided for round-trip tests.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

_VTK_CELL_TYPES = {1: 3, 2: 5}  # dim -> VTK_LINE / VTK_TRIANGLE


def _b64_block(arr: np.ndarray) -> str:
    """VTK binary inline encoding: uint32 byte count header + payload,
    base64 (the stdlib encoder)."""
    import base64

    raw = np.ascontiguousarray(arr).tobytes()
    header = np.uint32(len(raw)).tobytes()
    return base64.b64encode(header + raw).decode()


def _host(values) -> np.ndarray:
    """A numpy array of `values`, a tensor (any device) or array-like."""
    if hasattr(values, "detach"):
        values = values.detach().cpu().numpy()
    return np.asarray(values)


def write_vtu(path, mesh, point_data: dict, binary: bool = False,
              point_dtype=None) -> None:
    """Write one .vtu snapshot. point_data: name -> [n_verts] (numpy, or a
    tensor on any device). With `binary=True` data arrays are
    base64-encoded (smaller, faster to parse). `point_dtype=np.float32`
    halves archival series; the default keeps full Float64."""
    coords = mesh.coords
    cells = mesh.cells
    n_pts, dim = coords.shape
    pts3 = np.zeros((n_pts, 3))
    pts3[:, :dim] = coords
    vtk_type = _VTK_CELL_TYPES[dim]
    nv = cells.shape[1]

    fmt_attr = "binary" if binary else "ascii"

    def arr2str(a, fmt="{:.16g}"):
        return " ".join(fmt.format(x) for x in np.asarray(a).ravel())

    def emit(f, a, dtype):
        if binary:
            f.write("          "
                    + _b64_block(np.asarray(a, dtype).ravel()) + "\n")
        else:
            fmt = "{:d}" if np.issubdtype(np.dtype(dtype), np.integer) \
                else "{:.16g}"
            f.write("          " + arr2str(np.asarray(a, dtype), fmt) + "\n")

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write("  <UnstructuredGrid>\n")
        f.write(f'    <Piece NumberOfPoints="{n_pts}" '
                f'NumberOfCells="{len(cells)}">\n')
        f.write("      <Points>\n")
        f.write('        <DataArray type="Float64" NumberOfComponents="3" '
                f'format="{fmt_attr}">\n')
        emit(f, pts3, np.float64)
        f.write("        </DataArray>\n      </Points>\n")
        f.write("      <Cells>\n")
        f.write('        <DataArray type="Int32" Name="connectivity" '
                f'format="{fmt_attr}">\n')
        emit(f, cells, np.int32)
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="Int32" Name="offsets" '
                f'format="{fmt_attr}">\n')
        emit(f, np.arange(1, len(cells) + 1) * nv, np.int32)
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="UInt8" Name="types" '
                f'format="{fmt_attr}">\n')
        emit(f, np.full(len(cells), vtk_type), np.uint8)
        f.write("        </DataArray>\n      </Cells>\n")
        f.write("      <PointData>\n")
        pd = np.dtype(np.float64 if point_dtype is None else point_dtype)
        if pd not in (np.dtype(np.float64), np.dtype(np.float32)):
            raise ValueError(
                f"point_dtype must be float32 or float64, got {pd}")
        vtk_t = {8: "Float64", 4: "Float32"}[pd.itemsize]
        for name, values in point_data.items():
            f.write(f'        <DataArray type="{vtk_t}" Name="{name}" '
                    f'format="{fmt_attr}">\n')
            emit(f, _host(values), pd)
            f.write("        </DataArray>\n")
        f.write("      </PointData>\n")
        f.write("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")


def read_vtu(path, field_name: str) -> np.ndarray:
    """Minimal ascii-VTU point-data reader (test-side round-trips)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    for da in root.iter("DataArray"):
        if da.get("Name") == field_name:
            if da.get("format") == "binary":
                import base64

                raw = base64.b64decode(da.text.strip())
                n = int(np.frombuffer(raw[:4], np.uint32)[0])
                dt = {"Float64": np.float64,
                      "Float32": np.float32}[da.get("type", "Float64")]
                return np.frombuffer(raw[4:4 + n], dt).astype(np.float64)
            return np.array(da.text.split(), dtype=np.float64)
    raise KeyError(f"field '{field_name}' not found in {path}")


class VtuSeriesWriter:
    """A `<dir>/<name>/<name>.pvd` time series of `.vtu` snapshots
    (the dolfin File layout, `fedm/file_io.py:179-184`)."""

    def __init__(self, name: str, directory, binary: bool = False):
        self.name = name
        self.dir = Path(directory) / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.binary = binary
        self.snapshots = []  # (timestep, filename)

    def write(self, mesh, values, t: float, field_name: Optional[str] = None):
        fname = f"{self.name}{len(self.snapshots):06d}.vtu"
        write_vtu(self.dir / fname, mesh,
                  {field_name or self.name: _host(values)},
                  binary=self.binary)
        self.snapshots.append((t, fname))
        self._write_pvd()

    def _write_pvd(self):
        with open(self.dir / f"{self.name}.pvd", "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write('<VTKFile type="Collection" version="0.1" '
                    'byte_order="LittleEndian">\n  <Collection>\n')
            for t, fname in self.snapshots:
                f.write(f'    <DataSet timestep="{t}" part="0" '
                        f'file="{fname}" />\n')
            f.write("  </Collection>\n</VTKFile>\n")
