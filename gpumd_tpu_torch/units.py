"""Physical constants in GPUMD natural units (eV, Angstrom, amu, e).

Counterpart of gpumd_tpu/units.py (ref: src/utilities/common.cuh:18-28).
The natural time unit is 1 A*sqrt(amu/eV) = 10.18051 fs.
"""

# Boltzmann constant in eV/K.
K_B = 8.617343e-5

# Coulomb constant 1/(4 pi eps0) in eV*Angstrom/e^2.
K_C = 14.399645

# natural time -> fs.
TIME_UNIT_CONVERSION = 1.018051e1
