"""Building theta: the integral tensors the SCF engines consume.

Counterpart of dqc_tpu/scf/hamilton.py: a plain function from the dict of
differentiable tensors to the integral tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import integrals as I
from ..ops.eri import eri_dense
from ..utils.config import DTYPE
from ..utils.safeops import safe_cdist
from .orth import orthogonalizer


def nuclear_repulsion(atomzs, atompos):
    """E_nn = sum_{i<j} Z_i Z_j / r_ij."""
    z = torch.as_tensor(atomzs, dtype=atompos.dtype, device=atompos.device)
    r = safe_cdist(atompos, atompos, add_diag_eps=True)
    zz = z[:, None] * z[None, :] / r
    return 0.5 * (torch.sum(zz) - torch.sum(torch.diagonal(zz)))


def build_core_theta(meta, params, atomzs, *, efield=None, efield_grad=None,
                     efield_grad2=None, with_eri: bool = True,
                     ovlp_threshold: float = 1e-9, screened=None):
    """Builds the SCF theta dict (hcore, ovlp, X/keep, eri, enuc).

    efield: optional (3,) uniform electric field; adds +E.r_e coupling.
    efield_grad: optional (3,3) field gradient; adds (1/2!) sum G_de x_d x_e
    efield_grad2: optional (3,3,3) second field gradient; adds the
    (1/3!) sum G_def x_d x_e x_f octupole coupling.
    """
    pos = params["atompos"]

    def _t(x):
        return torch.as_tensor(x, dtype=DTYPE, device=pos.device)

    ovlp = I.overlap(meta, params)
    kin = I.kinetic(meta, params)
    nuc = I.nuclattr(meta, params, atomzs)
    hcore = kin + nuc
    if efield is not None:
        dip = torch.stack([I.multipole(meta, params, p)
                           for p in ((1, 0, 0), (0, 1, 0), (0, 0, 1))])
        # electrons have charge -1: H' = +E . r_e  (energy -mu.E with
        # mu_e = -sum r_e)
        hcore = hcore + torch.einsum("d,dij->ij", _t(efield), dip)
    if efield_grad is not None:
        pws = [[(2, 0, 0), (1, 1, 0), (1, 0, 1)],
               [(1, 1, 0), (0, 2, 0), (0, 1, 1)],
               [(1, 0, 1), (0, 1, 1), (0, 0, 2)]]
        quad = torch.stack([torch.stack([I.multipole(meta, params, pws[a][b])
                                         for b in range(3)])
                            for a in range(3)])
        hcore = hcore + 0.5 * torch.einsum("de,deij->ij", _t(efield_grad),
                                           quad)
    if efield_grad2 is not None:
        eye = np.eye(3, dtype=int)
        # 27 index triples share 10 distinct power tuples — compute each once
        uniq = {}

        def mono(a, b, c):
            pw = tuple(int(v) for v in (eye[a] + eye[b] + eye[c]))
            if pw not in uniq:
                uniq[pw] = I.multipole(meta, params, pw)
            return uniq[pw]

        octm = torch.stack([torch.stack([torch.stack(
            [mono(a, b, c) for c in range(3)])
            for b in range(3)]) for a in range(3)])
        hcore = hcore + (1.0 / 6.0) * torch.einsum(
            "def,defij->ij", _t(efield_grad2), octm)
    X, keep = orthogonalizer(ovlp, ovlp_threshold)
    theta = {
        "hcore": hcore,
        "ovlp": ovlp,
        "X": X,
        "keep": keep,
        "enuc": nuclear_repulsion(atomzs, pos),
    }
    if with_eri:
        theta["eri"] = eri_dense(meta, params, screened=screened)
    return theta
