from .mesh import Mesh, mesh_info
from .generators import interval_mesh, rectangle_mesh
from .marking import mark_boundaries

__all__ = ["Mesh", "mesh_info", "interval_mesh", "rectangle_mesh",
           "mark_boundaries"]
