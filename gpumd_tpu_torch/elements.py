"""Periodic-table data: element symbols (Z = 1..94) and standard atomic
masses.

Counterpart of gpumd_tpu/elements.py.  Masses are IUPAC standard atomic
weights (amu), the defaults the reference model reader uses when model.xyz
carries no mass column (ref: src/model/read_xyz.cu:36-130).
"""

SYMBOLS = (
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu",
)

_MASSES = (
    1.008, 4.002602, 6.94, 9.0121831, 10.81, 12.011, 14.007, 15.999,
    18.998403163, 20.1797, 22.98976928, 24.305, 26.9815385, 28.085,
    30.973761998, 32.06, 35.45, 39.948, 39.0983, 40.078, 44.955908,
    47.867, 50.9415, 51.9961, 54.938044, 55.845, 58.933194, 58.6934,
    63.546, 65.38, 69.723, 72.63, 74.921595, 78.971, 79.904, 83.798,
    85.4678, 87.62, 88.90584, 91.224, 92.90637, 95.95, 98.0, 101.07,
    102.9055, 106.42, 107.8682, 112.414, 114.818, 118.71, 121.76, 127.6,
    126.90447, 131.293, 132.90545196, 137.327, 138.90547, 140.116,
    140.90766, 144.242, 145.0, 150.36, 151.964, 157.25, 158.92535,
    162.5, 164.93033, 167.259, 168.93422, 173.045, 174.9668, 178.49,
    180.94788, 183.84, 186.207, 190.23, 192.217, 195.084, 196.966569,
    200.592, 204.38, 207.2, 208.9804, 210.0, 210.0, 222.0, 223.0, 226.0,
    227.0, 232.0377, 231.03588, 238.02891, 237.0, 244.0,
)

MASS_TABLE = dict(zip(SYMBOLS, _MASSES))

ATOMIC_NUMBERS = {s: i + 1 for i, s in enumerate(SYMBOLS)}


def mass_of(symbol: str) -> float:
    """Standard atomic mass of an element symbol; KeyError if unknown."""
    return MASS_TABLE[symbol]


def atomic_number(symbol: str) -> int:
    """Atomic number Z of an element symbol; 0 if unknown."""
    return ATOMIC_NUMBERS.get(symbol, 0)
