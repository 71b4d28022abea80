"""Approximation selection (LFA / LMEA), the JAX package's
`model/approximation.py`.

Same contract as the reference's `modify_approximation_vars`
(`fedm/functions.py:15-45`): under the local field approximation the first
species (the energy carrier placeholder) is dropped from every per-species
list; the number of equations is one more than the number of species (the
extra one is Poisson).
"""

from __future__ import annotations

from typing import List, Tuple

APPROXIMATION_TYPES = ("LFA", "LMEA")


def modify_approximation_vars(
    approximation_type: str,
    number_of_species: int,
    particle_species: List[str],
    masses: List[float],
    charges: List[float],
) -> Tuple[int, int, List[str], List[float], List[float]]:
    """(number of species, number of equations, species, masses, charges)
    under `approximation_type`; the lists are changed in place."""
    if approximation_type not in APPROXIMATION_TYPES:
        raise ValueError(
            f"The approximation type {approximation_type} is not recognised. "
            f"Must be one of {', '.join(repr(t) for t in APPROXIMATION_TYPES)}."
        )
    if approximation_type == "LFA":
        number_of_species -= 1
        particle_species.pop(0)
        masses.pop(0)
        charges.pop(0)
    number_of_eq = number_of_species + 1
    return number_of_species, number_of_eq, particle_species, masses, charges
