"""HF and KS SCF engines: plain functions of (density matrix, theta).

Counterpart of dqc_tpu/scf/engine.py (HFEngine, KSEngine). The engine owns
no tensors: `theta` (a dict of precomputed integrals, grid tables and
occupation weights) is the only state.

State convention: restricted -> dm (nao, nao); polarized -> dm (2, nao, nao).
A batch of B geometries (parallel/batch.py) puts a leading axis on the
state, (B, nao, nao) or (B, 2, nao, nao), and on every theta tensor,
(B, ...): the engines' products carry it, the kernels take it in one
launch, and energies come out (B,). The blocked and streamed J/K and a
periodic cell's J and K (scf/jk.py, ops/pbcft.py) contract member by
member.

Four routes for J and K, chosen by what theta carries:
  - dense: the exchange-layout tensor eri_k (eri_k[i,j,k,l] = (ik|jl)); J
    and K of every Fock build come from one pass of the fused kernel
    (ops/hopper_jk.py) over it, once per spin. A range-separated hybrid
    adds one erf-attenuated tensor per distinct omega in the same layout
    (eri_lr_k0, eri_lr_k1, ...), whose long-range K comes from the same
    kernel.
  - density-fitted: theta['df'] (scf/df.build_df_theta); RI-J and RI-K are
    plain torch products, as they are XLA einsums in the JAX package, and
    the long-range K of each omega comes from its attenuated-metric fit
    theta['df_lr{i}'].
  - blocked: the weighted canonical quartet blocks theta['jkb0'],
    theta['jkb1'], ... (scf/jk.py), contracted with the density on every
    Fock build, J and both spins' K in one pass over them.
  - streamed: the pair groups' Hermite factors theta['jk_facs']; every
    Fock build rebuilds each block, contracts it and drops it.
  - periodic (a Sol at the Gamma point): theta['pbcft'], the pair
    Fourier transforms of ops/pbcft.py; J and K are reciprocal-space
    products (aft_j, aft_k with the Madelung term), as in the JAX package,
    and the long-range K of each omega is the full K minus the short-range
    one on the weights wsr{i}. A periodic fit (densityfit(method="gdf"))
    takes the DF route, its long-range K the full fit's minus that of the
    short-range fit df_sr{i}.
The blocked and streamed routes need the engine's jk_info (the BasisMeta
and scf/jk.build_jk_meta's groups) and have no long-range exchange; a
functional without exact exchange builds J only there, as on the DF and
periodic routes.
"""
from __future__ import annotations

import torch

from ..ops.hopper_jk import ds_jk, ds_jk_kplanes
from ..ops.pbcft import aft_j, aft_k, aft_k_weighted
from ..xc.integrate import exc_energy, vxc_matrix
from .df import df_j, df_k
from .eigh import eigh_density
from .jk import jk_from_blocks, jk_matrices, theta_blocks, theta_factors
from .orth import LARGE


def orthogonal_fock_to_dm(fock, X, keep, occ):
    """fock: (..., nao, nao); X: (nao, nao) masked orthogonalizer, or (B,
    nao, nao) with keep (B, nao) for a batch whose fock is (B, [2,] nao,
    nao); occ: (..., nao) occupation weights aligned to ascending
    eigenvalues. Returns (dm, orbital energies, C)."""
    if fock.ndim > X.ndim and X.ndim == 3:     # a batch with a spin axis
        X, keep = X.unsqueeze(-3), keep.unsqueeze(-2)
    fp = torch.einsum("...im,...ij,...jn->...mn", X, fock, X)
    # pin masked-out directions high so they are never occupied
    pin = torch.where(keep, torch.zeros_like(X[..., 0, :]),
                      torch.full_like(X[..., 0, :], LARGE))
    fp = fp + torch.diag_embed(pin)
    p, w, u = eigh_density(fp, occ)
    c = torch.einsum("...ij,...jk->...ik", X, u)
    dm = torch.einsum("...ik,...kl,...jl->...ij", X, p, X)
    return dm, w, c


class HFEngine:
    """Restricted/unrestricted Hartree-Fock.

    theta keys: hcore (nao,nao), eri_k (nao,)*4, df, jkb{i} or jk_facs,
    ovlp, X, keep, occ, enuc. jk_info: (BasisMeta, jk_meta) of the blocked
    and streamed routes."""

    def __init__(self, polarized: bool = False, jk_info=None):
        self.polarized = polarized
        self.jk_info = jk_info

    def dm_tot(self, dm):
        return dm.sum(dim=-3) if self.polarized else dm

    def _spin(self, t):
        """t (..., n, n) with an axis for the spins of a polarized state."""
        return t.unsqueeze(-3) if self.polarized else t

    @staticmethod
    def _exact(theta):
        """Whether theta is on the blocked or the streamed route."""
        return "jkb0" in theta or "jk_facs" in theta

    def _exact_jk(self, theta, dm, want_j, want_k):
        """(J, K) from the cached blocks or the streamed factors."""
        bmeta, jkm = self.jk_info
        if "jkb0" in theta:
            return jk_from_blocks(bmeta, jkm, theta_blocks(theta, jkm), dm,
                                  want_j=want_j, want_k=want_k)
        return jk_matrices(bmeta, jkm, theta_factors(theta, jkm), dm,
                           want_j=want_j, want_k=want_k)

    def _j(self, theta, dm_tot):
        if "pbcft" in theta:
            return aft_j(theta["pbcft"], dm_tot)
        if "df" in theta:
            return df_j(theta["df"], dm_tot)
        if self._exact(theta):
            return self._exact_jk(theta, dm_tot, True, False)[0]
        return ds_jk_kplanes(theta["eri_k"], dm_tot.contiguous())[0]

    def _k(self, theta, dm):
        if "pbcft" in theta:
            return aft_k(theta, dm)
        if "df" in theta:
            return df_k(theta["df"], dm, self.polarized)
        if self.polarized:
            return torch.stack([ds_jk_kplanes(theta["eri_k"],
                                              d.contiguous())[1]
                                for d in dm.unbind(-3)], dim=-3)
        return ds_jk_kplanes(theta["eri_k"], dm.contiguous())[1]

    def jk_parts(self, dm, theta):
        """(J of the total density, K per spin): on the dense route from the
        fused kernel, one pass over eri_k per spin; on the DF route RI-J
        and RI-K; on the blocked and streamed routes from one pass over the
        blocks; on the periodic route from the pair transforms."""
        if "df" in theta or "pbcft" in theta:
            return self._j(theta, self.dm_tot(dm)), self._k(theta, dm)
        if self._exact(theta):
            return self._exact_jk(theta, dm, True, True)
        eri_k = theta["eri_k"]
        if self.polarized:
            ju, ku = ds_jk_kplanes(eri_k, dm.select(-3, 0).contiguous())
            jd, kd = ds_jk_kplanes(eri_k, dm.select(-3, 1).contiguous())
            return ju + jd, torch.stack([ku, kd], dim=-3)
        return ds_jk_kplanes(eri_k, dm.contiguous())

    def fock_from_parts(self, dm, j, k, theta):
        if self.polarized:
            return self._spin(theta["hcore"] + j) - k
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
        """Total energy from precomputed J/K ((B,) for a batch)."""
        dmt = self.dm_tot(dm)
        e1 = torch.einsum("...ij,...ij->...", theta["hcore"], dmt)
        ej = 0.5 * torch.einsum("...ij,...ij->...", j, dmt)
        if self.polarized:
            ek = -0.5 * torch.einsum("...sij,...sij->...", k, dm)
        else:
            ek = -0.25 * torch.einsum("...ij,...ij->...", k, dm)
        return e1 + ej + ek + theta["enuc"]

    def energy(self, dm, theta):
        return self.energy_from_parts(dm, *self.jk_parts(dm, theta), theta)

    # --- DIIS plumbing (solver iterates on the Fock matrix) ---
    def diis_err(self, fock, dm, theta):
        s, X = self._spin(theta["ovlp"]), self._spin(theta["X"])
        fds = torch.einsum("...ij,...jk,...kl->...il", fock, dm, s)
        comm = fds - fds.transpose(-1, -2)
        return torch.einsum("...im,...ij,...jn->...mn", X, comm, X)


class KSEngine(HFEngine):
    """Restricted/unrestricted Kohn-Sham with LDA, GGA and meta-GGA
    functionals, hybrid exact exchange (B3LYP, ...) and range-separated
    exact exchange (CAM-B3LYP, LC-BLYP, ...).

    Extra theta keys: the grid tables theta['grid'] (xc/integrate.
    setup_grid_theta), the NN parameters theta['xc_params'] of a CustomXC,
    and, per entry of xc.exx_lr, its erf-attenuated ERI eri_lr_k{i} in the
    exchange layout of eri_k (dense route) or its attenuated-metric fit
    df_lr{i} (DF route); the XC object is held on the engine.
    On the dense route K comes with J from the one pass of K1 even when the
    functional has no exact exchange; on the DF, blocked and streamed
    routes jk_parts computes no K (k = None) when xc.exx_fraction is 0, as
    the JAX package does. V_xc and
    E_xc come from xc/integrate, which takes the kernels K2/K3 for rho and
    grad rho on the card. The long-range K of each omega is one K1 pass
    per spin on eri_lr_k{i}, or RI-K on df_lr{i} (lr_parts);
    fock_from_parts and energy_from_parts compute it unless the caller
    passes it (klr=, as exc= for the XC energy)."""

    def __init__(self, xc, polarized: bool = False, jk_info=None):
        super().__init__(polarized, jk_info=jk_info)
        self.xc = xc

    def jk_parts(self, dm, theta):
        """HFEngine's, except that the DF, blocked, streamed and periodic
        routes compute no K for a functional without exact exchange (k =
        None)."""
        if self.xc.exx_fraction == 0.0 and ("df" in theta or "pbcft" in theta
                                            or self._exact(theta)):
            return self._j(theta, self.dm_tot(dm)), None
        return super().jk_parts(dm, theta)

    def _k_lr(self, theta, dm, i):
        """Exchange with the long-range erf(omega r)/r kernel of term i of
        xc.exx_lr: the trailing output of K1 on eri_lr_k{i}, one launch per
        spin (the same contraction as the JAX package's
        einsum("ikjl,...kl->...ij", eri_lr, dm)), or RI-K on the
        attenuated-metric fit df_lr{i}. Periodic (the JAX package's
        engine.py:131-148): the full K (with its Madelung term) minus the
        short-range K, on the pair transforms with the weights wsr{i} or as
        RI-K on the fits df and df_sr{i}."""
        key = f"eri_lr_k{i}"
        pol = self.polarized
        if f"df_lr{i}" in theta:
            return df_k(theta[f"df_lr{i}"], dm, pol)
        if f"df_sr{i}" in theta:
            return (df_k(theta["df"], dm, pol)
                    - df_k(theta[f"df_sr{i}"], dm, pol))
        if "pbcft" in theta:
            p = theta["pbcft"]
            return aft_k(theta, dm) - aft_k_weighted(p, dm, p[f"wsr{i}"])
        if key not in theta:
            raise ValueError(
                f"theta has no long-range exchange of term {i}: no dense "
                f"attenuated ERI ({key!r}), density fit (df_lr{i}, df_sr{i}) "
                "or periodic pair transforms (pbcft)")
        if pol:
            return torch.stack([ds_jk(theta[key], d.contiguous())[0]
                                for d in dm.unbind(-3)], dim=-3)
        return ds_jk(theta[key], dm.contiguous())[0]

    def lr_parts(self, dm, theta):
        """[K_lr of each term of xc.exx_lr] at dm."""
        return [self._k_lr(theta, dm, i)
                for i in range(len(self.xc.exx_lr))]

    def fock_from_parts(self, dm, j, k, theta, klr=None):
        vxc = vxc_matrix(self.xc, dm, theta["grid"], self.polarized,
                         xcparams=theta.get("xc_params"))
        if klr is None:
            klr = self.lr_parts(dm, theta)
        f = theta["hcore"] + j
        hyb = self.xc.exx_fraction
        # restricted: dm counts both spins, so each exchange takes half
        half = 1.0 if self.polarized else 0.5
        f = self._spin(f) + vxc
        if hyb != 0.0:
            f = f - half * hyb * k
        for (c, _), kl in zip(self.xc.exx_lr, klr):
            f = f - half * c * kl
        return f

    def energy_from_parts(self, dm, j, k, theta, exc=None, klr=None):
        """Total energy from precomputed J/K (and K_lr, else computed here);
        `exc` is the XC energy when the caller already has it (else one
        more grid pass computes it)."""
        dmt = self.dm_tot(dm)
        e1 = torch.einsum("...ij,...ij->...", theta["hcore"], dmt)
        ej = 0.5 * torch.einsum("...ij,...ij->...", j, dmt)
        if exc is None:
            exc = exc_energy(self.xc, dm, theta["grid"], self.polarized,
                             xcparams=theta.get("xc_params"))
        if klr is None:
            klr = self.lr_parts(dm, theta)
        e = e1 + ej + exc + theta["enuc"]
        # polarized: 1/2 sum_s <K_s, D_s>; restricted: 1/4 <K, D>
        quarter = 0.5 if self.polarized else 0.25
        tr = "...sij,...sij->..." if self.polarized else "...ij,...ij->..."
        hyb = self.xc.exx_fraction
        if hyb != 0.0:
            e = e - quarter * hyb * torch.einsum(tr, k, dm)
        for (c, _), kl in zip(self.xc.exx_lr, klr):
            e = e - quarter * c * torch.einsum(tr, kl, dm)
        return e
