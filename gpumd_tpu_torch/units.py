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

# eV/Angstrom^3 -> GPa.
PRESSURE_UNIT_CONVERSION = 1.602177e2

# hbar in eV x natural time.
HBAR = 6.465412e-2

# natural thermal conductivity -> W/(m K).
KAPPA_UNIT_CONVERSION = 1.573769e5

# pi to the reference's 15 digits (ref: common.cuh): the qNEP Ewald split
# alpha = PI / rc takes it
PI = 3.14159265358979
