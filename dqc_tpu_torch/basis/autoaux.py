"""Automatic even-tempered auxiliary basis for density fitting
(counterpart of dqc_tpu/basis/autoaux.py, the same shells, exponents and
order).

For each atom, the exponent range of every product density of the orbital
basis, expanded on an even-tempered grid for l up to 2*lmax (capped at 4),
in the spirit of Stoychev, Auer, Neese, JCTC 13, 554 (2017).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils.datastruct import AtomCGTOBasis, CGTOBasis


def autoaux_for_atom(bases: List[CGTOBasis], beta: float = 1.8,
                     lmax_cap: int = 4) -> List[CGTOBasis]:
    lmax = max(b.angmom for b in bases)
    # per-l exponent ranges of the product densities: a shell pair (la, lb)
    # contributes to aux l in |la-lb|..la+lb with exponent aa+ab
    amin_l = {}
    amax_l = {}
    for ba in bases:
        for bb in bases:
            lo_l = abs(ba.angmom - bb.angmom)
            hi_l = ba.angmom + bb.angmom
            pmin = float(np.min(ba.alphas) + np.min(bb.alphas))
            pmax = float(np.max(ba.alphas) + np.max(bb.alphas))
            for l in range(lo_l, hi_l + 1):
                amin_l[l] = min(amin_l.get(l, pmin), pmin)
                amax_l[l] = max(amax_l.get(l, pmax), pmax)
    out = []
    for l in range(min(2 * lmax, lmax_cap) + 1):
        if l not in amin_l:
            continue
        lo = 0.7 * amin_l[l]
        # very tight products are fit poorly but add little to the Coulomb
        # energy: the top of the range is damped above l = 0
        hi = amax_l[l] * (1.0 if l == 0 else 1.0 / (1.0 + 0.4 * l))
        n = max(int(np.ceil(np.log(hi / lo) / np.log(beta))) + 1, 1)
        exps = lo * beta ** np.arange(n)
        for a in exps:
            out.append(CGTOBasis(angmom=l, alphas=np.array([a]),
                                 coeffs=np.array([1.0])))
    return out


def autoaux(atombases: List[AtomCGTOBasis]) -> List[AtomCGTOBasis]:
    return [AtomCGTOBasis(atomz=ab.atomz,
                          bases=autoaux_for_atom(ab.bases),
                          pos=ab.pos) for ab in atombases]
