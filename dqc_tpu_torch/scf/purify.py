"""Eigh-free density matrix: canonical purification (counterpart of
dqc_tpu/scf/purify.py).

Palser and Manolopoulos (PRB 58, 12704 (1998)): the zero-temperature
density matrix of an orthogonalised Fock matrix from a fixed number of
matrix products, with no eigendecomposition and no chemical-potential
search. In the JAX package it replaces the emulated f64 eigensolver of the
TPU's device phase. The card has f64 eigh in cuSOLVER, so the port's SCF
keeps eigh (scf/engine.orthogonal_fock_to_dm) and nothing calls this on
its default path; it is here for callers that want a density matrix from
GEMMs alone, and chip_smoke.py holds it against eigh on benzene's
converged Fock matrix.

Valid for integer aufbau occupations (occ in {0, f}, one f > 0 per spin
channel: 2 restricted, 1 polarized). Orbital energies are not produced.
"""
from __future__ import annotations

import torch

# the JAX package's default count (its DQC_TPU_PURIFY_ITERS is not
# carried over): enough for benzene/def2-SVP, whose gap is 0.016 of the
# spectral width, to reach 1e-10 in the frontier occupations
PURIFY_ITERS = 96


def purify_orth(fp, nocc, iters: int = PURIFY_ITERS):
    """Density matrix (orthogonal frame, trace nocc, spectrum {0, 1}) of
    the symmetric orthogonal-frame Fock fp (..., n, n); nocc the number of
    occupied orbitals (a number or a tensor of the batch shape).
    Grand-canonical start from the Gershgorin bounds of fp, then `iters`
    trace-conserving PM steps
        c = tr(D^2 - D^3) / tr(D - D^2)
        D <- ((1 + c) D^2 - D^3) / c                    if c >= 1/2
        D <- ((1 - 2c) D + (1 + c) D^2 - D^3) / (1 - c)  otherwise
    with c = 1/2 (McWeeny's 3 D^2 - 2 D^3) once tr(D - D^2) <= 1e-8, where
    the ratio of two traces of rounding noise would kick D (the JAX
    package's endgame)."""
    n = fp.shape[-1]
    eye = torch.eye(n, dtype=fp.dtype, device=fp.device)
    diag = torch.diagonal(fp, dim1=-2, dim2=-1)
    off = torch.abs(fp).sum(-1) - torch.abs(diag)
    fmin = torch.amin(diag - off, dim=-1)
    fmax = torch.amax(diag + off, dim=-1)
    mu = diag.sum(-1) / n
    nocc = torch.as_tensor(nocc, dtype=fp.dtype, device=fp.device)
    lam = torch.minimum(nocc / torch.clamp(fmax - mu, min=1e-300),
                        (n - nocc) / torch.clamp(mu - fmin, min=1e-300))
    d = ((lam / n)[..., None, None] * (mu[..., None, None] * eye - fp)
         + (nocc / n)[..., None, None] * eye)
    for _ in range(iters):
        d2 = d @ d
        d3 = d2 @ d
        tr_d2d3 = torch.diagonal(d2 - d3, dim1=-2, dim2=-1).sum(-1)
        tr_dd2 = torch.diagonal(d - d2, dim1=-2, dim2=-1).sum(-1)
        c = tr_d2d3 / torch.where(torch.abs(tr_dd2) > 1e-300, tr_dd2,
                                  torch.ones_like(tr_dd2))
        c = torch.clamp(c, 1e-6, 1.0 - 1e-6)
        c = torch.where(tr_dd2 > 1e-8, c, torch.full_like(c, 0.5))
        cb = c[..., None, None]
        hi = ((1.0 + cb) * d2 - d3) / cb
        lo = ((1.0 - 2.0 * cb) * d + (1.0 + cb) * d2 - d3) / (1.0 - cb)
        d = torch.where(cb >= 0.5, hi, lo)
    return d


def fock_to_dm_purify(fock, X, keep, occ, iters: int = PURIFY_ITERS):
    """AO density matrix from the AO Fock matrix by canonical
    purification: the counterpart of engine.orthogonal_fock_to_dm's dm for
    integer aufbau occupations (occ (..., nao), entries {0, f}). Masked
    orthogonaliser directions are pinned just above the spectrum (at 1.5
    times the Gershgorin width, not at orth.LARGE: purification converges
    at the rate of the gap relative to the spectral width, which a 1e7 pin
    would squash)."""
    fp = torch.einsum("im,...ij,jn->...mn", X, fock, X)
    diag0 = torch.diagonal(fp, dim1=-2, dim2=-1)
    off0 = torch.abs(fp).sum(-1) - torch.abs(diag0)
    gmin = torch.amin(diag0 - off0, dim=-1)
    gmax = torch.amax(diag0 + off0, dim=-1)
    pin_val = gmax + 0.5 * (gmax - gmin) + 1.0
    pinm = torch.where(keep, 0.0, 1.0).to(fp.dtype)
    fp = fp + pin_val[..., None, None] * torch.diag(pinm)
    f_max = torch.amax(occ, dim=-1)
    nocc = occ.sum(-1) / torch.clamp(f_max, min=1e-300)
    d_orth = purify_orth(fp, nocc, iters)
    return f_max[..., None, None] * torch.einsum("im,...mn,jn->...ij", X,
                                                 d_orth, X)
