"""Periodic-table data: symbols, atomic numbers, masses, radii.

TPU-native rebuild of the tables in the reference implementation
(dqc/utils/periodictable.py of diffqc/dqc) — data re-entered from standard
published sources (CRC / Slater 1964 Bragg radii / CODATA masses).
"""
from __future__ import annotations

# Element symbols indexed by atomic number (index 0 unused).
SYMBOLS = [
    "X",
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
    "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy",
    "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt",
    "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn",
]

SYMBOL_TO_Z = {s: z for z, s in enumerate(SYMBOLS) if z > 0}
# accept lowercase / uppercase variants
for _s, _z in list(SYMBOL_TO_Z.items()):
    SYMBOL_TO_Z[_s.lower()] = _z
    SYMBOL_TO_Z[_s.upper()] = _z

# Standard atomic weights (amu), index = Z (0 unused). Z = 1..54 + a few.
ATOM_MASSES = [
    0.0,
    1.00794, 4.002602,
    6.941, 9.012182, 10.811, 12.0107, 14.0067, 15.9994, 18.9984032, 20.1797,
    22.98976928, 24.3050, 26.9815386, 28.0855, 30.973762, 32.065, 35.453, 39.948,
    39.0983, 40.078, 44.955912, 47.867, 50.9415, 51.9961, 54.938045, 55.845,
    58.933195, 58.6934, 63.546, 65.38,
    69.723, 72.64, 74.92160, 78.96, 79.904, 83.798,
    85.4678, 87.62, 88.90585, 91.224, 92.90638, 95.96, 98.0, 101.07, 102.90550,
    106.42, 107.8682, 112.411,
    114.818, 118.710, 121.760, 127.60, 126.90447, 131.293,
]

# Bragg-Slater atomic radii in Bohr (Slater, J. Chem. Phys. 41, 3199 (1964)),
# used by Becke partitioning atom-size adjustments and grid construction.
# Values in Angstrom here; converted below. H is conventionally 0.35 A
# (Becke used 0.35 A for H rather than Slater's 0.25 A in some schemes; we
# follow the common quadrature convention of 0.35 A as in PySCF's BRAGG table
# which uses 0.35 for H).
_BRAGG_ANGSTROM = [
    0.75,  # dummy
    0.35, 1.40,  # H treated specially below (PySCF uses 0.35)
    1.45, 1.05, 0.85, 0.70, 0.65, 0.60, 0.50, 1.50,
    1.80, 1.50, 1.25, 1.10, 1.00, 1.00, 1.00, 1.88,
    2.20, 1.80, 1.60, 1.40, 1.35, 1.40, 1.40, 1.40, 1.35, 1.35, 1.35, 1.35,
    1.30, 1.25, 1.15, 1.15, 1.15, 2.02,
    2.35, 2.00, 1.80, 1.55, 1.45, 1.45, 1.35, 1.30, 1.35, 1.40, 1.60, 1.55,
    1.55, 1.45, 1.45, 1.40, 1.40, 2.16,
]

ANGSTROM_TO_BOHR = 1.0 / 0.529177210903
BRAGG_RADII = [r * ANGSTROM_TO_BOHR for r in _BRAGG_ANGSTROM]


def get_atomz(s) -> int:
    """Symbol or integer-like -> atomic number."""
    if isinstance(s, str):
        ss = s.strip()
        if ss.isdigit():
            return int(ss)
        cap = ss.capitalize()
        if cap in SYMBOL_TO_Z:
            return SYMBOL_TO_Z[cap]
        raise ValueError(f"Unknown element symbol: {s!r}")
    if isinstance(s, (int, float)):
        if float(s) != int(s):
            raise ValueError(
                "Fractional atomic numbers must be passed as tensors, not in "
                "the string molecule description")
        return int(s)
    raise TypeError(f"Cannot interpret {s!r} as an element")


def get_atom_mass(z: int) -> float:
    """Atomic mass in atomic units (electron masses)."""
    return ATOM_MASSES[z] * 1822.888486209  # amu -> a.u. (m_e)


def get_bragg_radius(z: int) -> float:
    return BRAGG_RADII[z] if z < len(BRAGG_RADII) else BRAGG_RADII[-1]


# expectation values <r> of the outermost atomic orbital, in Bohr
# (published table, doi:10.1007/s00214-012-1169-z — the "expected" atom
# radii the reference uses for its Dasgupta sg2/sg3 grids,
# periodictable.py:150-186); index = Z (0 = ghost)
EXPECTED_RADII = [
    1.0,
    1.0, 0.927272, 3.873661, 2.849396, 2.204757, 1.714495, 1.409631,
    1.232198, 1.084786, 0.965273, 4.208762, 3.252938, 3.433889, 2.752216,
    2.322712, 2.060717, 1.842024, 1.662954, 5.243652, 4.218469, 3.959716,
    3.778855, 3.626288, 3.675012, 3.381917, 3.258487, 3.153572, 3.059109,
    3.330979, 2.897648, 3.424103, 2.866859, 2.512233, 2.299617, 2.111601,
    1.951590,
]


def get_expected_radius(z: int) -> float:
    return EXPECTED_RADII[z] if z < len(EXPECTED_RADII) else EXPECTED_RADII[-1]
