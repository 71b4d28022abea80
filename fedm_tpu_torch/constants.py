"""Physical constants (SI units), the same CODATA values as the JAX package
so that coefficient pipelines agree bit for bit."""

elementary_charge = 1.6021766208e-19  # [C]
epsilon_0 = 8.854187817e-12  # vacuum permittivity [F/m]

pi = 3.141592653589793

# dolfin's DOLFIN_EPS, used by the reference in its relative step-error
# estimate (`fedm/functions.py:1062-1064`).
DOLFIN_EPS = 3e-16
