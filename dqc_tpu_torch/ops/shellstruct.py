"""Shell packing: ragged Gaussian bases -> class-grouped tensors.

Counterpart of dqc_tpu/ops/shellstruct.py:
  - shells are grouped into *classes* by angular momentum l; within a class
    primitive counts are padded to the class max, so each class is one
    batched tensor program.
  - `BasisMeta` is hashable host-side metadata (ls, atom ids, AO offsets).
  - `params` is a plain dict of tensors — the differentiable inputs: atom
    positions, exponents, raw contraction coefficients.

Contraction normalization is done inside the tensor code
(`normalized_coeffs`) so gradients w.r.t. exponents flow through it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from scipy.special import gammaln

from ..utils.datastruct import AtomCGTOBasis
from .sph_data import SPH_COEFFS


def ncart(l: int) -> int:
    return (l + 1) * (l + 2) // 2


def nsph(l: int) -> int:
    return 2 * l + 1


def sph_transform(l: int) -> np.ndarray:
    """(2l+1, ncart) real-solid-harmonic coefficients (unit-L2 Y_lm)."""
    return np.asarray(SPH_COEFFS[l], dtype=np.float64)


@dataclass(frozen=True)
class ShellClass:
    """All shells sharing one angular momentum (host-side static)."""
    l: int
    kmax: int                      # padded primitive count
    shell_ids: tuple               # global shell indices, len ns
    atom_ids: tuple                # atom index per shell, len ns
    ao_starts: tuple               # first (spherical) AO index per shell

    @property
    def nshell(self) -> int:
        return len(self.shell_ids)


@dataclass(frozen=True)
class BasisMeta:
    """Hashable static description of the basis (no numerical params)."""
    classes: Tuple[ShellClass, ...]
    nao: int
    nshell: int
    natom: int
    # per global shell: (class index, index within class)
    shell_loc: tuple

    def class_of_l(self, l: int):
        for i, c in enumerate(self.classes):
            if c.l == l:
                return i
        return None

    @property
    def max_l(self) -> int:
        return max(c.l for c in self.classes)


def pack_basis(atombases: Sequence[AtomCGTOBasis], device="cpu"):
    """Pack atom bases into (BasisMeta, params dict).

    params: {'atompos': (natm,3), 'alphas': [per-class (ns,kmax)],
             'coeffs': [per-class (ns,kmax)], 'mask': [per-class (ns,kmax)]}
    'coeffs' are the *raw* (pre-normalization) contraction coefficients;
    `normalized_coeffs` always renormalizes inside the tensor code.
    """
    shells = []  # (l, alphas, coeffs, atom_idx)
    atompos = []
    for ia, ab in enumerate(atombases):
        atompos.append(np.asarray(ab.pos, dtype=np.float64))
        for b in ab.bases:
            al = np.asarray(b.alphas, np.float64)
            co = np.asarray(b.coeffs, np.float64)
            if getattr(b, "normalized", False):
                # undo the primitive L2 norm so `normalized_coeffs` (which
                # re-applies it) is exact.
                co = co / np.exp(0.5 * (np.log(2.0)
                                        + (b.angmom + 1.5) * np.log(2.0 * al)
                                        - gammaln(b.angmom + 1.5)))
            shells.append((b.angmom, al, co, ia))
    atompos = np.stack(atompos, axis=0)

    # AO offsets in original shell order (spherical AOs)
    ao_off = np.zeros(len(shells) + 1, dtype=np.int64)
    for i, (l, _, _, _) in enumerate(shells):
        ao_off[i + 1] = ao_off[i] + nsph(l)
    nao = int(ao_off[-1])

    # group by l
    by_l: Dict[int, List[int]] = {}
    for i, (l, _, _, _) in enumerate(shells):
        by_l.setdefault(l, []).append(i)

    classes = []
    alphas_list, coeffs_list, mask_list = [], [], []
    shell_loc = [None] * len(shells)
    for ci, l in enumerate(sorted(by_l)):
        ids = by_l[l]
        kmax = max(len(shells[i][1]) for i in ids)
        ns = len(ids)
        al = np.ones((ns, kmax), dtype=np.float64)
        co = np.zeros((ns, kmax), dtype=np.float64)
        ma = np.zeros((ns, kmax), dtype=np.float64)
        for row, i in enumerate(ids):
            k = len(shells[i][1])
            al[row, :k] = shells[i][1]
            co[row, :k] = shells[i][2]
            ma[row, :k] = 1.0
            shell_loc[i] = (ci, row)
        classes.append(ShellClass(
            l=l, kmax=kmax,
            shell_ids=tuple(ids),
            atom_ids=tuple(shells[i][3] for i in ids),
            ao_starts=tuple(int(ao_off[i]) for i in ids),
        ))
        alphas_list.append(torch.as_tensor(al, device=device))
        coeffs_list.append(torch.as_tensor(co, device=device))
        mask_list.append(torch.as_tensor(ma, device=device))

    meta = BasisMeta(classes=tuple(classes), nao=nao, nshell=len(shells),
                     natom=len(atombases), shell_loc=tuple(shell_loc))
    params = {
        "atompos": torch.as_tensor(atompos, device=device),
        "alphas": alphas_list,
        "coeffs": coeffs_list,
        "mask": mask_list,
    }
    return meta, params


def normalized_coeffs(l: int, alphas, coeffs, mask):
    """Wavefunction normalization inside the tensor code: primitive L2 norm
    then contracted self-overlap.

    alphas/coeffs/mask: (ns, k). Returns (ns, k) normalized coefficients
    (zero where masked out)."""
    gl = float(gammaln(l + 1.5))
    lognorm = 0.5 * (np.log(2.0) + (l + 1.5) * torch.log(2.0 * alphas) - gl)
    c1 = coeffs * torch.exp(lognorm) * mask
    # <unnormalized radial prim i | j> = Gamma(l+1.5) / (2 (ai+aj)^{l+1.5})
    aij = alphas[:, :, None] + alphas[:, None, :]
    ov = torch.exp(gl - np.log(2.0) - (l + 1.5) * torch.log(aij))
    s = torch.einsum("si,sj,sij->s", c1, c1, ov)
    return c1 / torch.sqrt(s)[:, None]


@dataclass(frozen=True)
class PairClassMeta:
    """Index lists for one (class_a, class_b) shell-pair group (host-side)."""
    ca: int
    cb: int
    ia: np.ndarray = field(compare=False)   # (npair,) index into class a
    ib: np.ndarray = field(compare=False)   # (npair,) index into class b

    @property
    def npair(self) -> int:
        return len(self.ia)


def plan_pairs(na: int, nb: int, triangular: bool):
    """Shell-pair lists (ia, ib): the full cross product, or ia <= ib."""
    if triangular:
        iu = np.triu_indices(na)
        return iu[0].astype(np.int32), iu[1].astype(np.int32)
    ia, ib = np.meshgrid(np.arange(na), np.arange(nb), indexing="ij")
    return ia.ravel().astype(np.int32), ib.ravel().astype(np.int32)


def tri_pair_classes(meta: BasisMeta) -> List[PairClassMeta]:
    """Unique shell pairs: class pairs with ca <= cb; within equal classes
    only ia <= ib. Callers symmetrize the assembled matrix."""
    out = []
    for ca, A in enumerate(meta.classes):
        for cb in range(ca, len(meta.classes)):
            B = meta.classes[cb]
            ia, ib = plan_pairs(A.nshell, B.nshell, triangular=(ca == cb))
            out.append(PairClassMeta(ca=ca, cb=cb, ia=ia, ib=ib))
    return out


def all_pair_classes(meta: BasisMeta) -> List[PairClassMeta]:
    """All ordered shell pairs: every (class_a, class_b) with the full cross
    product of their shells, so each entry of an (nao, nao) matrix belongs
    to exactly one pair (the k-point pair transforms, where the two AO
    orders are independent)."""
    out = []
    for ca, A in enumerate(meta.classes):
        for cb, B in enumerate(meta.classes):
            ia, ib = plan_pairs(A.nshell, B.nshell, triangular=False)
            out.append(PairClassMeta(ca=ca, cb=cb, ia=ia, ib=ib))
    return out


def gather_pair_inputs(meta: BasisMeta, params, pc: PairClassMeta):
    """Device-side inputs for one pair class.

    Returns dict with:
      A, B: (np, 3) shell centers
      aa, ab: (np, ka) / (np, kb) exponents
      ca, cb: (np, ka) / (np, kb) normalized, masked contraction coefficients
    """
    A_cls = meta.classes[pc.ca]
    B_cls = meta.classes[pc.cb]
    pos = params["atompos"]
    dev = pos.device
    ca_norm = normalized_coeffs(A_cls.l, params["alphas"][pc.ca],
                                params["coeffs"][pc.ca], params["mask"][pc.ca])
    cb_norm = normalized_coeffs(B_cls.l, params["alphas"][pc.cb],
                                params["coeffs"][pc.cb], params["mask"][pc.cb])
    ia = torch.as_tensor(np.asarray(pc.ia, dtype=np.int64), device=dev)
    ib = torch.as_tensor(np.asarray(pc.ib, dtype=np.int64), device=dev)
    atom_a = torch.as_tensor(np.asarray(A_cls.atom_ids, dtype=np.int64),
                             device=dev)[ia]
    atom_b = torch.as_tensor(np.asarray(B_cls.atom_ids, dtype=np.int64),
                             device=dev)[ib]
    return {
        "A": pos[atom_a], "B": pos[atom_b],
        "aa": params["alphas"][pc.ca][ia], "ab": params["alphas"][pc.cb][ib],
        "ca": ca_norm[ia], "cb": cb_norm[ib],
        "la": A_cls.l, "lb": B_cls.l,
    }


def pair_ao_indices(meta: BasisMeta, pc: PairClassMeta) -> np.ndarray:
    """(npair, nsph_a, nsph_b) flat int64 indices into an (nao, nao) matrix."""
    A_cls = meta.classes[pc.ca]
    B_cls = meta.classes[pc.cb]
    na, nb = nsph(A_cls.l), nsph(B_cls.l)
    row0 = np.asarray(A_cls.ao_starts, dtype=np.int64)[pc.ia]     # (np,)
    col0 = np.asarray(B_cls.ao_starts, dtype=np.int64)[pc.ib]
    rows = row0[:, None, None] + np.arange(na)[None, :, None]
    cols = col0[:, None, None] + np.arange(nb)[None, None, :]
    return rows * meta.nao + cols
