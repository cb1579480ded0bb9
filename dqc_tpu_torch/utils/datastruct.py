"""Core data structures: SpinParam and the basis containers.

Counterpart of dqc_tpu/utils/datastruct.py. Plain dataclasses: PyTorch needs
no pytree registration. ValGrad comes with the property API (ROADMAP A13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Generic, List, Sequence, TypeVar, Union

import numpy as np

T = TypeVar("T")


@dataclass
class SpinParam(Generic[T]):
    """Container for spin-polarized quantities (u = up/alpha, d = down/beta)."""
    u: T
    d: T

    def sum(self):
        return self.u + self.d

    def reduce(self, fcn: Callable):
        return fcn(self.u, self.d)

    @staticmethod
    def apply_fcn(fcn: Callable, *params):
        """Apply fcn elementwise over SpinParam members; non-SpinParam args
        are broadcast to both channels. Returns SpinParam if any arg is one,
        else plain value."""
        if any(isinstance(p, SpinParam) for p in params):
            us = [p.u if isinstance(p, SpinParam) else p for p in params]
            ds = [p.d if isinstance(p, SpinParam) else p for p in params]
            return SpinParam(u=fcn(*us), d=fcn(*ds))
        return fcn(*params)

    @staticmethod
    def sum_if(x):
        return x.sum() if isinstance(x, SpinParam) else x


@dataclass
class CGTOBasis:
    """One contracted Gaussian shell: angular momentum + primitives.

    Host-side (numpy) description; device tensors are built by the shell
    packer (ops/shellstruct.py)."""
    angmom: int
    alphas: np.ndarray   # (nprim,)
    coeffs: np.ndarray   # (nprim,)
    normalized: bool = False

    def wfnormalize_(self) -> "CGTOBasis":
        """Normalize primitives then the contraction so the contracted
        spherical GTO has unit self-overlap (libcint/PySCF convention)."""
        from scipy.special import gammaln
        if self.normalized:
            return self
        l = self.angmom
        a = np.asarray(self.alphas, dtype=np.float64)
        c = np.asarray(self.coeffs, dtype=np.float64)
        # primitive norm of r^l e^{-a r^2} with a unit-L2 spherical harmonic:
        # N(a) = sqrt( 2 (2a)^{l+1.5} / Gamma(l+1.5) )
        lognorm = 0.5 * (np.log(2.0) + (l + 1.5) * np.log(2.0 * a)
                         - gammaln(l + 1.5))
        c = c * np.exp(lognorm)
        # contracted self-overlap with *unnormalized* radial primitives:
        # <r^l e^{-ai r^2} | r^l e^{-aj r^2}> = Gamma(l+1.5) / (2 p^{l+1.5})
        aij = a[:, None] + a[None, :]
        ovlp = np.exp(gammaln(l + 1.5) - np.log(2.0)
                      - (l + 1.5) * np.log(aij))
        s = float(np.einsum("i,j,ij->", c, c, ovlp))
        c = c / np.sqrt(s)
        return CGTOBasis(angmom=l, alphas=a, coeffs=c, normalized=True)


@dataclass
class AtomCGTOBasis:
    atomz: Union[int, float]
    bases: List[CGTOBasis]
    pos: Sequence[float]  # (3,) in Bohr


@dataclass
class DensityFitInfo:
    """Density fitting of a molecule: the method ("coulomb") and the
    auxiliary basis, one entry per atom in the molecule's atom order."""
    method: str
    auxbases: List[AtomCGTOBasis]
