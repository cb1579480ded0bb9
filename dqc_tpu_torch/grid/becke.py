"""Becke fuzzy-cell partition weights (counterpart of
dqc_tpu/grid/becke.py), in torch on the device: three iterations of the
smoothing polynomial f <- f(3-f^2)/2, the atom-size adjustment from Bragg
radii, and small-eps guards so that gradients in the atom positions stay
finite. Recomputed from atompos, so the quadrature moves with the atoms.

The cell functions form a (points, atoms, atoms) array. becke_weights cuts
the points into chunks whose arrays take about utils/config's
PBC_BLOCK_BYTES (the wrapped grid of a periodic cell has hundreds of
virtual atoms); each point's weight is the same function of its own
coordinates in every chunk. Under autograd a chunk is recomputed in the
backward (torch.utils.checkpoint) instead of keeping its arrays.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..utils.config import block_bytes
from ..utils.safeops import safenorm

# (points, atoms, atoms) arrays of one chunk alive at the same time
_LIVE_ARRAYS = 3


def becke_weights(coords, atom_idx, atompos, atom_radii=None):
    """coords: (ng, 3) grid points; atom_idx: (ng,) int64 owning atom;
    atompos: (natm, 3); atom_radii: optional (natm,) Bragg radii for the
    atom-size adjustment. Returns (ng,) partition weights."""
    ng, natm = coords.shape[0], atompos.shape[0]
    chunk = max(1, block_bytes(coords.device)
                // (8 * _LIVE_ARRAYS * natm * natm))
    if ng <= chunk:
        return _becke_block(coords, atom_idx, atompos, atom_radii)
    remat = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (coords, atompos, atom_radii))
    out = []
    for s in range(0, ng, chunk):
        args = (coords[s:s + chunk], atom_idx[s:s + chunk], atompos,
                atom_radii)
        out.append(checkpoint(_becke_block, *args, use_reentrant=False)
                   if remat else _becke_block(*args))
    return torch.cat(out)


def _becke_block(coords, atom_idx, atompos, atom_radii=None):
    """becke_weights of one chunk of points. The (points, atoms, atoms)
    steps run in place wherever autograd keeps no copy of their operand,
    with the halves folded into the constants (a product with 0.5 is
    exact, so the bits are those of 0.5 f (3 - f^2) and 0.5 (1 - f))."""
    natm = atompos.shape[0]
    eye = torch.eye(natm, dtype=coords.dtype, device=coords.device)
    # distances from each point to each atom: (ng, natm)
    d = safenorm(coords[:, None, :] - atompos[None, :, :], axis=-1)
    rij = safenorm(atompos[:, None, :] - atompos[None, :, :], axis=-1)
    rij = rij + eye    # avoid 0 on the diagonal
    # mu_ij(r) = (d_i - d_j) / R_ij : (ng, natm, natm)
    mu = (d[:, :, None] - d[:, None, :]).div_(rij)
    if atom_radii is not None:
        chi = atom_radii[:, None] / atom_radii[None, :]
        u = (chi - 1.0) / (chi + 1.0)
        a = torch.clamp(u / (u * u - 1.0), -0.45, 0.45)
        # all radii equal (one element) and no gradient in them: a = 0 and
        # mu + 0 (1 - mu^2) = mu
        if atom_radii.requires_grad or bool((a != 0).any()):
            mu = mu + a[None] * (1.0 - mu * mu)
    f = mu
    for _ in range(3):
        f = f * (f * f).mul_(-0.5).add_(1.5)     # 0.5 f (3 - f^2)
    s = f.mul_(-0.5).add_(0.5)                   # 0.5 (1 - f)
    # cell function P_i = prod_{j != i} s_ij
    s.diagonal(dim1=1, dim2=2).fill_(1.0)
    P = torch.prod(s, dim=-1)                    # (ng, natm)
    denom = torch.clamp(torch.sum(P, dim=-1), min=1e-300)
    w_all = P / denom[:, None]
    return torch.gather(w_all, 1, atom_idx[:, None])[:, 0]
