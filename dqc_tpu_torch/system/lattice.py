"""3D Bravais lattice and the Ewald energy of point charges (counterpart of
dqc_tpu/system/lattice.py).

The lattice vectors `a` stay a tensor on the calculation's device; the
enumerations of lattice translations and reciprocal vectors, whose counts
depend on the values, run on the host in numpy from the concrete value.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.config import DTYPE


class Lattice:
    def __init__(self, a, device="cpu"):
        """a: (3, 3) lattice vectors in rows, Bohr."""
        if isinstance(a, torch.Tensor):
            self.a = a.to(device=device, dtype=DTYPE)
        else:
            self.a = torch.as_tensor(np.asarray(a, dtype=np.float64),
                                     device=device)
        self._a_np = self.a.detach().cpu().numpy()

    def lattice_vectors(self):
        return self.a

    def recip_vectors(self):
        """b = 2 pi a^-T (rows)."""
        return 2.0 * math.pi * torch.linalg.inv(self.a).T

    def volume(self):
        return torch.abs(torch.linalg.det(self.a))

    # --- host-side enumerations -----------------------------------------
    def get_lattice_ls(self, rcut: float):
        """All lattice translations with |L| <= rcut: (nL, 3) numpy."""
        a = self._a_np
        inv_len = np.linalg.norm(np.linalg.inv(a), axis=1)
        nmax = np.ceil(rcut * inv_len).astype(int) + 1
        rng = [np.arange(-n, n + 1) for n in nmax]
        ijk = np.stack(np.meshgrid(*rng, indexing="ij"),
                       axis=-1).reshape(-1, 3)
        ls = ijk @ a
        keep = np.linalg.norm(ls, axis=1) <= rcut + 1e-12
        return ls[keep]

    def get_gvgrids(self, gcut: float):
        """Reciprocal vectors with |G| <= gcut: ((ng, 3), integer indices
        (ng, 3)), numpy."""
        b = 2.0 * np.pi * np.linalg.inv(self._a_np).T
        inv_len = np.linalg.norm(np.linalg.inv(b), axis=1)
        nmax = np.ceil(gcut * inv_len).astype(int) + 1
        rng = [np.arange(-n, n + 1) for n in nmax]
        ijk = np.stack(np.meshgrid(*rng, indexing="ij"),
                       axis=-1).reshape(-1, 3)
        gv = ijk @ b
        keep = np.linalg.norm(gv, axis=1) <= gcut + 1e-12
        return gv[keep], ijk[keep]

    def estimate_ewald_eta(self) -> float:
        """Split parameter eta ~ sqrt(pi) / V^(1/3), clipped to [0.1, 10]."""
        vol = float(np.abs(np.linalg.det(self._a_np)))
        return float(np.clip(np.sqrt(np.pi) / vol ** (1.0 / 3.0), 0.1, 10.0))


def ewald_energy(atomzs, atompos, lattice: Lattice, eta: float = None,
                 precision: float = 1e-10):
    """Ewald sum of point charges in a neutralising background: the
    real-space, reciprocal-space, self and background terms. Differentiable
    in atompos and atomzs."""
    pos = torch.as_tensor(atompos, dtype=DTYPE, device=lattice.a.device)
    z = torch.as_tensor(atomzs, dtype=DTYPE, device=pos.device)
    natm = pos.shape[0]
    vol = lattice.volume()
    if eta is None:
        eta = lattice.estimate_ewald_eta()
    rcut = float(np.sqrt(-np.log(precision)) / eta * 1.2 + 1.0)
    gcut = float(2.0 * eta * np.sqrt(-np.log(precision)) * 1.2 + 1.0)
    ls_np = lattice.get_lattice_ls(rcut)
    ls = torch.as_tensor(ls_np, device=pos.device)
    gv = torch.as_tensor(lattice.get_gvgrids(gcut)[0], device=pos.device)

    # real space: 1/2 sum_{i,j,L}' z_i z_j erfc(eta |r_ij + L|) / |r_ij + L|
    rij = pos[:, None, None, :] - pos[None, :, None, :] + ls[None, None]
    d = torch.sqrt(torch.sum(rij * rij, dim=-1) + 1e-300)
    self_mask = (torch.as_tensor(np.sum(ls_np * ls_np, axis=-1) < 1e-20,
                                 device=pos.device)[None, None, :]
                 & torch.eye(natm, dtype=torch.bool,
                             device=pos.device)[:, :, None])
    contrib = torch.where(self_mask, torch.zeros_like(d),
                          torch.special.erfc(eta * d) / d)
    e_real = 0.5 * torch.einsum("i,j,ijl->", z, z, contrib)

    # reciprocal: (2 pi / V) sum_{G != 0} |S(G)|^2 exp(-G^2 / 4 eta^2) / G^2
    g2 = torch.sum(gv * gv, dim=-1)
    nonzero = g2 > 1e-20
    phase = gv @ pos.T
    s2 = (torch.cos(phase) @ z) ** 2 + (torch.sin(phase) @ z) ** 2
    g2_safe = torch.where(nonzero, g2, torch.ones_like(g2))
    e_recip = (2.0 * math.pi / vol) * torch.sum(torch.where(
        nonzero, s2 * torch.exp(-g2_safe / (4 * eta * eta)) / g2_safe,
        torch.zeros_like(g2)))

    # self and neutralising background
    e_self = -eta / math.sqrt(math.pi) * torch.sum(z * z)
    e_bg = -math.pi / (2.0 * eta * eta * vol) * torch.sum(z) ** 2
    return e_real + e_recip + e_self + e_bg
