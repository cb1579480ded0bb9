"""Hartree-Fock SCF engine: plain functions of (density matrix, theta).

Counterpart of dqc_tpu/scf/engine.py (HFEngine; KSEngine comes with the
grid and XC stack). The engine owns no tensors: `theta` (a dict of precomputed
integrals + occupation weights) is the only state.

State convention: restricted -> dm (nao, nao); polarized -> dm (2, nao, nao).

theta carries the exchange-layout tensor eri_k (eri_k[i,j,k,l] = (ik|jl))
only; J and K of every Fock build come from one pass of the fused kernel
(ops/hopper_jk.py) over it, once per spin. The periodic, blocked, streamed
and density-fitted branches of the JAX engine are not ported yet.
"""
from __future__ import annotations

import torch

from ..ops.hopper_jk import ds_jk_kplanes
from .eigh import safe_eigh
from .orth import LARGE


def orthogonal_fock_to_dm(fock, X, keep, occ):
    """fock: (..., nao, nao); X: (nao, nao) masked orthogonalizer;
    occ: (..., nao) occupation weights aligned to ascending eigenvalues.
    Returns (dm, orbital energies, C)."""
    fp = torch.einsum("im,...ij,jn->...mn", X, fock, X)
    # pin masked-out directions high so they are never occupied
    pin = torch.where(keep, torch.zeros_like(X[0]),
                      torch.full_like(X[0], LARGE))
    fp = fp + torch.diag(pin)
    w, u = safe_eigh(fp)
    c = torch.einsum("ij,...jk->...ik", X, u)
    dm = torch.einsum("...ik,...k,...jk->...ij", c, occ, c)
    return dm, w, c


class HFEngine:
    """Restricted/unrestricted Hartree-Fock.

    theta keys: hcore (nao,nao), eri_k (nao,)*4, ovlp, X, keep, occ, enuc."""

    def __init__(self, polarized: bool = False):
        self.polarized = polarized

    def dm_tot(self, dm):
        return dm.sum(dim=0) if self.polarized else dm

    def _j(self, theta, dm_tot):
        return ds_jk_kplanes(theta["eri_k"], dm_tot.contiguous())[0]

    def _k(self, theta, dm):
        if dm.ndim == 3:
            return torch.stack([self._k(theta, d) for d in dm])
        return ds_jk_kplanes(theta["eri_k"], dm.contiguous())[1]

    def jk_parts(self, dm, theta):
        """(J of the total density, K per spin) from the fused kernel: one
        pass over eri_k per spin."""
        eri_k = theta["eri_k"]
        if self.polarized:
            ju, ku = ds_jk_kplanes(eri_k, dm[0].contiguous())
            jd, kd = ds_jk_kplanes(eri_k, dm[1].contiguous())
            return ju + jd, torch.stack([ku, kd])
        return ds_jk_kplanes(eri_k, dm.contiguous())

    def fock_from_parts(self, dm, j, k, theta):
        if self.polarized:
            return theta["hcore"][None] + j[None] - k
        return theta["hcore"] + j - 0.5 * k

    def fock(self, dm, theta):
        return self.fock_from_parts(dm, *self.jk_parts(dm, theta), theta)

    def dm_from_fock(self, fock, theta):
        dm, _, _ = orthogonal_fock_to_dm(fock, theta["X"], theta["keep"],
                                         theta["occ"])
        return dm

    def step(self, dm, theta):
        return self.dm_from_fock(self.fock(dm, theta), theta)

    def energy_from_parts(self, dm, j, k, theta):
        """Total energy from precomputed J/K."""
        dmt = self.dm_tot(dm)
        e1 = torch.einsum("ij,ij->", theta["hcore"], dmt)
        ej = 0.5 * torch.einsum("ij,ij->", j, dmt)
        if self.polarized:
            ek = -0.5 * torch.einsum("sij,sij->", k, dm)
        else:
            ek = -0.25 * torch.einsum("ij,ij->", k, dm)
        return e1 + ej + ek + theta["enuc"]

    def energy(self, dm, theta):
        return self.energy_from_parts(dm, *self.jk_parts(dm, theta), theta)

    # --- DIIS plumbing (solver iterates on the Fock matrix) ---
    def diis_err(self, fock, dm, theta):
        s, X = theta["ovlp"], theta["X"]
        fds = torch.einsum("...ij,...jk,kl->...il", fock, dm, s)
        comm = fds - fds.transpose(-1, -2)
        return torch.einsum("im,...ij,jn->...mn", X, comm, X)
