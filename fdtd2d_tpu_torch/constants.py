"""Physical constants.

Values match the reference conventions (reference: python-src/main.py:100-101,
python-src/fdfd.py:37-38) so that fields are numerically comparable.
"""

EPSILON_0 = 8.85418e-12   # vacuum permittivity [F/m]
MU_0 = 4.0e-7 * 3.141592653589793  # vacuum permeability [H/m]

# The diffusion-surrogate datagen in the reference uses slightly different
# constants (reference: python-src/diffusion_training.py:70-72).
EPSILON_0_DATAGEN = 8.85418782e-12
MU_0_DATAGEN = 1.25663706e-6
