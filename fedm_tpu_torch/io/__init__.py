from .files import Files, files, truncate_file
from .logging import log
from .vtu import VtuSeriesWriter, read_vtu, write_vtu
from .xdmf import XdmfH5Writer, read_checkpoints
from .output import OutputSeries, file_output
from .checkpoint import load_checkpoint, save_checkpoint
from .convenience import mesh_statistics, output_files

__all__ = [
    "Files", "files", "truncate_file", "log",
    "VtuSeriesWriter", "write_vtu", "read_vtu",
    "XdmfH5Writer", "read_checkpoints",
    "OutputSeries", "file_output",
    "save_checkpoint", "load_checkpoint",
    "output_files", "mesh_statistics",
]
