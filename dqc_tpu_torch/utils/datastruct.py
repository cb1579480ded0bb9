"""Core data structures: SpinParam and the basis containers.

Counterpart of dqc_tpu/utils/datastruct.py. Plain dataclasses: PyTorch needs
no pytree registration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Generic, List, Optional, Sequence, TypeVar, Union

import numpy as np
import torch

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
class ValGrad:
    """Density information at grid points (the JAX package's ValGrad,
    dqc_tpu/utils/datastruct.py:61-100).

    value: the density n(r), (*B, nr)
    grad: its gradient (d/dx, d/dy, d/dz), (*B, 3, nr), or None
    lapl: its Laplacian, (*B, nr), or None
    kin: the kinetic energy density tau, (*B, nr), or None

    `+` adds two of them component by component (both or neither must have
    each component); `*` scales every component by a factor."""
    value: object
    grad: Optional[object] = None
    lapl: Optional[object] = None
    kin: Optional[object] = None

    def __add__(self, other: "ValGrad") -> "ValGrad":
        def add(x, y):
            if x is None and y is None:
                return None
            if x is None or y is None:
                raise ValueError(
                    "Cannot add ValGrad with mismatched components")
            return x + y
        return ValGrad(value=self.value + other.value,
                       grad=add(self.grad, other.grad),
                       lapl=add(self.lapl, other.lapl),
                       kin=add(self.kin, other.kin))

    def __mul__(self, f):
        return ValGrad(value=self.value * f,
                       grad=None if self.grad is None else self.grad * f,
                       lapl=None if self.lapl is None else self.lapl * f,
                       kin=None if self.kin is None else self.kin * f)

    __rmul__ = __mul__


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


# the leaves of a calc's params (SCF_QCCalc._all_params) that vary from
# member to member of a batch of geometries; every other leaf (the basis
# exponents and coefficients, xc_params, fields) is shared
BATCH_PATHS = (("basis", "atompos"), ("atomzs",))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    """A copy of the dicts along `path` with the leaf there replaced."""
    out = dict(tree)
    out[path[0]] = (value if len(path) == 1
                    else _put(tree[path[0]], path[1:], value))
    return out


def batch_params(params, atompos_b, atomzs_b=None):
    """A batched params tree: `params` (a calc's _all_params()) with the
    positions atompos_b (B, natom, 3) and the charges atomzs_b (B, natom)
    (default: params' own for every member) on a leading member axis; the
    other leaves are shared, with no batch axis."""
    atompos_b = torch.as_tensor(atompos_b, dtype=params["atomzs"].dtype,
                                device=params["atomzs"].device)
    if atomzs_b is None:
        atomzs_b = params["atomzs"].expand(atompos_b.shape[0], -1)
    out = _put(params, ("basis", "atompos"), atompos_b)
    return _put(out, ("atomzs",), torch.as_tensor(atomzs_b).to(atompos_b))


def batch_size(params_b) -> int:
    """The number of members of a batched params tree."""
    return int(_get(params_b, BATCH_PATHS[0]).shape[0])


def member_params(params_b, m: int):
    """Member m of a batched params tree: its own positions and charges,
    the shared leaves as they are (the same tensors, so a gradient in them
    sums over the members)."""
    out = params_b
    for path in BATCH_PATHS:
        out = _put(out, path, _get(params_b, path)[m])
    return out


def tree_member(tree, m):
    """Member m of a stacked tree (parallel/batch's theta, whose tensors
    carry a leading member axis): every tensor indexed at m (a view), or
    with m a list of members every tensor taken at them (a sub-batch);
    anything else (floats, ints, None) as it is, and so is the entry
    "xc_params", the members' shared tree."""
    if isinstance(tree, dict):
        return {k: v if k == "xc_params" else tree_member(v, m)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        if isinstance(m, int):
            return tree[m]
        return tree[torch.as_tensor(m, device=tree.device)]
    return tree


def tree_batch_of_one(tree):
    """An unbatched tree as a stacked tree of one member (tree_member's
    inverse at m = 0): every tensor a view with a leading axis of 1 (its
    jk_tag kept), anything else and the entry "xc_params" as they are."""
    if isinstance(tree, dict):
        return {k: v if k == "xc_params" else tree_batch_of_one(v)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        out = tree[None]
        tag = getattr(tree, "jk_tag", None)
        if tag is not None:
            out.jk_tag = tag
        return out
    return tree


def stack_members(outs, dim: int = 0):
    """The members' results of a loop, stacked: outs is a list of tensors,
    of None, or of tuples/lists of those (each entry stacked on its own;
    None stays None)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs, dim=dim)
    return type(first)(stack_members(list(o), dim) for o in zip(*outs))
