"""Legacy DOLFIN XML mesh reader and writer (the JAX package's
`mesh/io_xml.py`).

The reference's streamer example loads its mesh as `Mesh('mesh.xml')`;
this reader takes that format, so meshes exported from legacy FEniCS
tooling load directly. The writer's output is byte for byte the JAX
package's.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from .mesh import Mesh

_CELL_TAGS = {"interval": ("interval", 2), "triangle": ("triangle", 3)}


def read_dolfin_xml(path) -> Mesh:
    root = ET.parse(path).getroot()
    mesh_el = root.find("mesh")
    if mesh_el is None:
        raise ValueError(f"'{path}' is not a dolfin mesh XML file")
    celltype = mesh_el.get("celltype")
    if celltype not in _CELL_TAGS:
        raise ValueError(f"unsupported celltype '{celltype}'")
    dim = int(mesh_el.get("dim"))
    tag, nv = _CELL_TAGS[celltype]

    verts_el = mesh_el.find("vertices")
    coords = np.zeros((int(verts_el.get("size")), dim))
    axes = ["x", "y", "z"][:dim]
    for v in verts_el.iter("vertex"):
        coords[int(v.get("index"))] = [float(v.get(a)) for a in axes]

    cells_el = mesh_el.find("cells")
    cells = np.zeros((int(cells_el.get("size")), nv), dtype=np.int32)
    for c in cells_el.iter(tag):
        cells[int(c.get("index"))] = [int(c.get(f"v{k}")) for k in range(nv)]
    return Mesh(coords, cells)


def write_dolfin_xml(path, mesh: Mesh) -> None:
    celltype = "interval" if mesh.dim == 1 else "triangle"
    axes = ["x", "y", "z"][: mesh.dim]
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<dolfin xmlns:dolfin="http://fenicsproject.org">\n')
        f.write(f'  <mesh celltype="{celltype}" dim="{mesh.dim}">\n')
        f.write(f'    <vertices size="{mesh.n_verts}">\n')
        for i, x in enumerate(mesh.coords):
            attrs = " ".join(f'{a}="{float(v)!r}"' for a, v in zip(axes, x))
            f.write(f'      <vertex index="{i}" {attrs} />\n')
        f.write("    </vertices>\n")
        f.write(f'    <cells size="{mesh.n_cells}">\n')
        for i, c in enumerate(mesh.cells):
            attrs = " ".join(f'v{k}="{int(v)}"' for k, v in enumerate(c))
            f.write(f'      <{celltype} index="{i}" {attrs} />\n')
        f.write("    </cells>\n  </mesh>\n</dolfin>\n")
