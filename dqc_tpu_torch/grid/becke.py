"""Becke fuzzy-cell partition weights (counterpart of
dqc_tpu/grid/becke.py), in torch on the device: three iterations of the
smoothing polynomial f <- f(3-f^2)/2, the atom-size adjustment from Bragg
radii, and small-eps guards so that gradients in the atom positions stay
finite. Recomputed from atompos, so the quadrature moves with the atoms.
"""
from __future__ import annotations

import torch

from ..utils.safeops import safenorm


def becke_weights(coords, atom_idx, atompos, atom_radii=None):
    """coords: (ng, 3) grid points; atom_idx: (ng,) int64 owning atom;
    atompos: (natm, 3); atom_radii: optional (natm,) Bragg radii for the
    atom-size adjustment. Returns (ng,) partition weights."""
    natm = atompos.shape[0]
    eye = torch.eye(natm, dtype=coords.dtype, device=coords.device)
    # distances from each point to each atom: (ng, natm)
    d = safenorm(coords[:, None, :] - atompos[None, :, :], axis=-1)
    rij = safenorm(atompos[:, None, :] - atompos[None, :, :], axis=-1)
    rij = rij + eye    # avoid 0 on the diagonal
    # mu_ij(r) = (d_i - d_j) / R_ij : (ng, natm, natm)
    mu = (d[:, :, None] - d[:, None, :]) / rij[None, :, :]
    if atom_radii is not None:
        chi = atom_radii[:, None] / atom_radii[None, :]
        u = (chi - 1.0) / (chi + 1.0)
        a = torch.clamp(u / (u * u - 1.0), -0.45, 0.45)
        mu = mu + a[None] * (1.0 - mu * mu)
    f = mu
    for _ in range(3):
        f = 0.5 * f * (3.0 - f * f)
    s = 0.5 * (1.0 - f)                           # (ng, natm, natm)
    # cell function P_i = prod_{j != i} s_ij
    s = s * (1.0 - eye)[None] + eye[None]
    P = torch.prod(s, dim=-1)                     # (ng, natm)
    denom = torch.clamp(torch.sum(P, dim=-1), min=1e-300)
    w_all = P / denom[:, None]
    return torch.gather(w_all, 1, atom_idx[:, None])[:, 0]
