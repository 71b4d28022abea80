"""Physical constants (SI units), the same CODATA values as the JAX package
so that coefficient pipelines agree bit for bit."""

elementary_charge = 1.6021766208e-19  # [C]
me = 9.10938356e-31  # electron mass [kg]
epsilon_0 = 8.854187817e-12  # vacuum permittivity [F/m]
kB = 1.38064852e-23  # Boltzmann constant [J/K]
kB_eV = 8.6173303e-5  # Boltzmann constant [eV/K]
M_atomic = 1.66053906660e-27  # atomic mass unit [kg]

pi = 3.141592653589793

# dolfin's DOLFIN_EPS, used by the reference in its relative step-error
# estimate (`fedm/functions.py:1062-1064`).
DOLFIN_EPS = 3e-16
