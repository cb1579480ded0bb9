"""HF and KS SCF engines: plain functions of (density matrix, theta).

Counterpart of dqc_tpu/scf/engine.py (HFEngine, KSEngine). The engine owns
no tensors: `theta` (a dict of precomputed integrals, grid tables and
occupation weights) is the only state.

State convention: restricted -> dm (nao, nao); polarized -> dm (2, nao, nao).

theta carries the exchange-layout tensor eri_k (eri_k[i,j,k,l] = (ik|jl))
only; J and K of every Fock build come from one pass of the fused kernel
(ops/hopper_jk.py) over it, once per spin. The periodic, blocked, streamed
and density-fitted branches of the JAX engine are not ported yet.
"""
from __future__ import annotations

import torch

from ..ops.hopper_jk import ds_jk_kplanes
from ..xc.integrate import exc_energy, vxc_matrix
from .eigh import eigh_density
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
    p, w, u = eigh_density(fp, occ)
    c = torch.einsum("ij,...jk->...ik", X, u)
    dm = torch.einsum("ik,...kl,jl->...ij", X, p, X)
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


class KSEngine(HFEngine):
    """Restricted/unrestricted Kohn-Sham with LDA/GGA functionals and
    hybrid exact exchange (B3LYP etc.).

    Extra theta key: the grid tables theta['grid'] (xc/integrate.
    setup_grid_theta); the XC object is held on the engine. jk_parts is
    HFEngine's: K comes with J from the one pass of K1 even when the
    functional has no exact exchange. V_xc and E_xc come from
    xc/integrate, which takes the kernels K2/K3 for a GGA on the card.
    Range-separated exchange (exx_lr) is not ported yet."""

    def __init__(self, xc, polarized: bool = False):
        super().__init__(polarized)
        self.xc = xc

    def _k_lr(self, theta, dm, i):
        raise NotImplementedError(
            "not ported yet: long-range exact exchange of the "
            "range-separated hybrids (ROADMAP A10)")

    def fock_from_parts(self, dm, j, k, theta):
        vxc = vxc_matrix(self.xc, dm, theta["grid"], self.polarized,
                         xcparams=theta.get("xc_params"))
        f = theta["hcore"] + j
        hyb = self.xc.exx_fraction
        if self.polarized:
            f = f[None] + vxc
            if hyb != 0.0:
                f = f - hyb * k
        else:
            f = f + vxc
            if hyb != 0.0:
                f = f - 0.5 * hyb * k
        for i, _ in enumerate(self.xc.exx_lr):
            f = f - self._k_lr(theta, dm, i)
        return f

    def energy_from_parts(self, dm, j, k, theta, exc=None):
        """Total energy from precomputed J/K; `exc` is the XC energy when the
        caller already has it (else one more grid pass computes it)."""
        dmt = self.dm_tot(dm)
        e1 = torch.einsum("ij,ij->", theta["hcore"], dmt)
        ej = 0.5 * torch.einsum("ij,ij->", j, dmt)
        if exc is None:
            exc = exc_energy(self.xc, dm, theta["grid"], self.polarized,
                             xcparams=theta.get("xc_params"))
        e = e1 + ej + exc + theta["enuc"]
        hyb = self.xc.exx_fraction
        if hyb != 0.0:
            if self.polarized:
                e = e - 0.5 * hyb * torch.einsum("sij,sij->", k, dm)
            else:
                e = e - 0.25 * hyb * torch.einsum("ij,ij->", k, dm)
        for i, _ in enumerate(self.xc.exx_lr):
            e = e - self._k_lr(theta, dm, i)
        return e
