"""Convenience factories matching the reference's file_io surface."""

from __future__ import annotations

from typing import List

from .files import files as _files
from .vtu import VtuSeriesWriter
from .xdmf import XdmfH5Writer
from ..utils.process import print_process_0


def output_files(file_type: str, type_of_output: str,
                 output_file_names: List[str], mesh=None,
                 output_dir=None) -> List:
    """Create one writer per name under `<output>/<type_of_output>/<name>/`
    (the reference's `output_files`, `fedm/file_io.py:148-188`).

    file_type: 'pvd' -> VtuSeriesWriter, 'xdmf' -> XdmfH5Writer.
    """
    base = (output_dir if output_dir is not None
            else _files.output_folder_path) / type_of_output
    if file_type == "pvd":
        return [VtuSeriesWriter(name, base) for name in output_file_names]
    if file_type == "xdmf":
        return [XdmfH5Writer(name, base, mesh=mesh)
                for name in output_file_names]
    raise ValueError(
        f"file type '{file_type}' is not valid. Options are 'pvd' or 'xdmf'.")


def mesh_statistics(mesh, output_dir=None) -> str:
    """Write `mesh/mesh.vtu` and `mesh/mesh info.txt` under the output
    folder and print the statistics (the reference's `mesh_statistics`,
    `fedm/file_io.py:619-631`). Returns the info string."""
    from ..mesh import mesh_info
    from .vtu import write_vtu

    base = (output_dir if output_dir is not None
            else _files.output_folder_path) / "mesh"
    base.mkdir(parents=True, exist_ok=True)
    write_vtu(base / "mesh.vtu", mesh, {})
    info = mesh_info(mesh)
    print_process_0(info.rstrip())
    with open(base / "mesh info.txt", "w") as f:
        f.write(info)
    return info
