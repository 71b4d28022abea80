from .elements import (cell_quadrature, facet_quadrature, n_local_dofs,
                       tabulate)
from .space import FunctionSpace
from .assembly import (CellBatch, FacetBatch, interpolate, project,
                       vector_l2_norm)
from .dirichlet import BCSet, DirichletBC, combine_bcs

__all__ = ["tabulate", "n_local_dofs", "cell_quadrature",
           "facet_quadrature", "FunctionSpace", "CellBatch", "FacetBatch",
           "interpolate", "project", "vector_l2_norm", "BCSet",
           "DirichletBC", "combine_bcs"]
