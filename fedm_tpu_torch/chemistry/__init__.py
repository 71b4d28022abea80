"""Chemistry front end: the reference's on-disk input formats (parsers),
coefficient tables and their evaluation, and the source terms."""

from .coefficients import Coefficient, RateCoefficients, TransportCoefficients
from .parsers import (rate_coefficient_file_names, reaction_matrices,
                      read_energy_loss, read_particle_properties,
                      read_speclist)
from .sources import (energy_source_factors, reaction_rates,
                      semi_implicit_coefficient, species_sources)

__all__ = [
    "Coefficient", "RateCoefficients", "TransportCoefficients",
    "rate_coefficient_file_names", "reaction_matrices", "read_energy_loss",
    "read_particle_properties", "read_speclist", "energy_source_factors",
    "reaction_rates", "semi_implicit_coefficient", "species_sources",
]
