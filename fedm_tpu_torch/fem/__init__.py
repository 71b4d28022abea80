from .elements import cell_quadrature, facet_quadrature, tabulate
from .space import FunctionSpace
from .assembly import CellBatch, FacetBatch
from .dirichlet import BCSet, DirichletBC

__all__ = ["tabulate", "cell_quadrature", "facet_quadrature",
           "FunctionSpace", "CellBatch", "FacetBatch", "BCSet",
           "DirichletBC"]
