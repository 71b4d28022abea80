"""Low-pressure argon glow discharge (LMEA), the JAX package's
`models/glow.py`: a configuration of the generic N-species builder
(`models.generic.PlasmaModel`) that pins the reference script's
hand-declared per-species metadata (`fedm-gd.py:58-61`):

  equation_type = ['reaction', 'diffusion-reaction',
                   'drift-diffusion-reaction', 'drift-diffusion-reaction']
  particle_type = ['Heavy', 'Heavy', 'Heavy', 'electrons']
  particle_species_type = ['Neutral', 'Neutral', 'Ion', 'electrons']
  ref_coeff = (0.3, 0.3, 5e-4, 0.3)

State per node: u[:, 0] = ln w_e, u[:, 1] = ln n_Ar*, u[:, 2] = ln n_Ar+,
u[:, 3] = ln n_e, u[:, 4] = Phi.
"""

from __future__ import annotations

from dataclasses import dataclass

from .generic import PlasmaConfig, PlasmaModel


@dataclass
class GlowConfig(PlasmaConfig):
    """The reference glow script's configuration (`fedm-gd.py:40-61`)."""

    ref_metallic: tuple = (0.3, 0.3, 5e-4, 0.3)
    equation_types: tuple = ("reaction", "diffusion-reaction",
                             "drift-diffusion-reaction",
                             "drift-diffusion-reaction")
    particle_types: tuple = ("Heavy", "Heavy", "Heavy", "electrons")
    species_types: tuple = ("Neutral", "Neutral", "Ion", "electrons")


class GlowDischargeModel(PlasmaModel):
    pass
