"""Unit conversions to/from atomic units.

Parity surface with the reference's converters
(dqc/utils/units.py of diffqc/dqc); constants from CODATA 2014/2018.
Everything inside the framework is atomic units (Hartree, Bohr, a.u. time).
"""
from __future__ import annotations

import math

# fundamental conversions
BOHR_TO_ANGSTROM = 0.529177210903
ANGSTROM_TO_BOHR = 1.0 / BOHR_TO_ANGSTROM
HARTREE_TO_EV = 27.211386245988
HARTREE_TO_KCALMOL = 627.5094740631
HARTREE_TO_KJMOL = 2625.4996394799
AMU_TO_AU = 1822.888486209  # atomic mass unit -> electron masses

# frequency: a.u. (sqrt(Hartree / (m_e Bohr^2)) / (2 pi c)) -> cm^-1
# omega [a.u.] * AU2CM = wavenumber in cm^-1
_SPEED_OF_LIGHT_AU = 137.035999084
_BOHR_TO_CM = BOHR_TO_ANGSTROM * 1e-8
FREQ_AU_TO_CM1 = 1.0 / (2 * math.pi * _SPEED_OF_LIGHT_AU * _BOHR_TO_CM)

# dipole: a.u. (e * Bohr) -> Debye
AU_TO_DEBYE = 2.541746473

_LENGTH = {
    "bohr": 1.0, "a.u.": 1.0, "au": 1.0,
    "angst": ANGSTROM_TO_BOHR, "angstrom": ANGSTROM_TO_BOHR, "a": ANGSTROM_TO_BOHR,
}
_ENERGY = {
    "hartree": 1.0, "a.u.": 1.0, "au": 1.0,
    "ev": 1.0 / HARTREE_TO_EV,
    "kcal/mol": 1.0 / HARTREE_TO_KCALMOL,
    "kj/mol": 1.0 / HARTREE_TO_KJMOL,
}
_FREQ = {
    "a.u.": 1.0, "au": 1.0,
    "cm-1": 1.0 / FREQ_AU_TO_CM1, "cm^-1": 1.0 / FREQ_AU_TO_CM1,
}


def _convert(val, unit, table, name):
    if unit is None:
        return val
    key = unit.lower()
    if key not in table:
        raise ValueError(f"Unknown {name} unit: {unit}")
    return val * table[key]


def length_to_au(val, unit=None):
    return _convert(val, unit, _LENGTH, "length")


def energy_to_au(val, unit=None):
    return _convert(val, unit, _ENERGY, "energy")


def freq_to_cm1(val_au):
    return val_au * FREQ_AU_TO_CM1


def au_to_debye(val_au):
    return val_au * AU_TO_DEBYE


# IR integrated molar absorption: A[km/mol] = 974.8801 |dmu/dQ|^2 with
# dmu/dQ in e * amu^{-1/2} (standard conversion, e.g. CCCBDB conventions);
# the extra AMU_TO_AU moves from the internal all-a.u. normal coordinates.
IR_INT_AU_TO_KMMOL = 974.8801 * AMU_TO_AU
# Raman activity bohr^4/m_e -> angstrom^4/amu
RAMAN_AU_TO_ANGST4_AMU = AMU_TO_AU * BOHR_TO_ANGSTROM ** 4
