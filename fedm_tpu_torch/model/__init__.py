from .forms import (balance_equation_contrib, bdf2_history_part,
                    drift_diffusion_flux, poisson_contrib)
from .system import CoupledSystem, StepOperators, StepParams

__all__ = ["bdf2_history_part", "drift_diffusion_flux",
           "balance_equation_contrib", "poisson_contrib", "CoupledSystem",
           "StepOperators", "StepParams"]
