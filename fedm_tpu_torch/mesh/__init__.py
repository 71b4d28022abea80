from .mesh import Mesh
from .generators import rectangle_mesh
from .marking import mark_boundaries

__all__ = ["Mesh", "rectangle_mesh", "mark_boundaries"]
