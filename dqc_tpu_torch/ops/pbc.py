"""Lattice-summed one-electron integrals with k-points (counterpart of
dqc_tpu/ops/pbc.py):

    S_k[i, j] = sum_L e^{i k.L} <phi_i | phi_j(. - L)>,

a real-space lattice sum of the molecular McMurchie-Davidson pair integrals,
batched over (pair, L). Plain torch, so differentiable in the atom
positions and the basis parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.config import DTYPE
from .integrals import _const, _gather_e0, _pair_weights, _sph_pair
from .mcd import _cart_components, e_coeffs_stacked, gaussian_product
from .shellstruct import (BasisMeta, gather_pair_inputs, pair_ao_indices,
                          tri_pair_classes)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def estimate_rcut(meta, params, precision: float = 1e-10) -> float:
    """Cutoff on the translation norm |T| of lattice sums of pair quantities
    f(r_i, r_j + T) so that the neglected overlap tails are below
    `precision`: the decay length of the most diffuse primitive plus the
    largest distance between two atoms of the cell (without that pad a
    multi-atom cell loses images between far-apart atoms)."""
    amin = min(float(np.min(_np(a))) for a in params["alphas"])
    rdecay = float(np.sqrt(-2.0 * np.log(precision) / amin)) + 2.0
    pos = _np(params["atompos"]).astype(np.float64)
    dmax = 0.0
    if pos.shape[0] > 1:
        diff = pos[:, None, :] - pos[None, :, :]
        dmax = float(np.max(np.sqrt(np.sum(diff * diff, axis=-1))))
    return rdecay + dmax


def _pair_block(kind, inp):
    """(np, nsph_a, nsph_b) overlap or kinetic blocks of the pair inputs."""
    la, lb = inp["la"], inp["lb"]
    gp = gaussian_product(la, lb, inp["A"], inp["B"], inp["aa"], inp["ab"])
    w = _pair_weights(inp, gp)
    nca = (la + 1) * (la + 2) // 2
    if kind == "overlap":
        Earr = e_coeffs_stacked(la, lb, gp["PA"], gp["PB"], gp["inv2p"])
        Ex, Ey, Ez = _gather_e0(Earr, la, lb, lb)
        blk = torch.einsum("pabc,pab->pc", Ex * Ey * Ez, w)
    elif kind == "kinetic":
        Earr = e_coeffs_stacked(la, lb + 2, gp["PA"], gp["PB"], gp["inv2p"])
        S0 = _gather_e0(Earr, la, lb, lb + 2, 0)
        Sp2 = _gather_e0(Earr, la, lb, lb + 2, +2)
        Sm2 = _gather_e0(Earr, la, lb, lb + 2, -2)
        ca_l, cb_l = _cart_components(la), _cart_components(lb)
        jpow = _const(np.array([[pb[d] for pa in ca_l for pb in cb_l]
                                for d in range(3)], dtype=np.float64), Earr)
        b = inp["ab"][:, None, :, None]
        K = [b * (2 * jpow[d] + 1) * S0[d] - 2.0 * b * b * Sp2[d]
             - 0.5 * jpow[d] * (jpow[d] - 1) * Sm2[d] for d in range(3)]
        v = (K[0] * S0[1] * S0[2] + S0[0] * K[1] * S0[2]
             + S0[0] * S0[1] * K[2])
        blk = torch.einsum("pabc,pab->pc", v, w)
    else:
        raise ValueError(kind)
    return _sph_pair(blk.reshape(blk.shape[0], nca, -1), la, lb)


def pbc_int1e(kind, meta: BasisMeta, params, ls, kpts):
    """Lattice-sum one-electron integrals ('overlap' or 'kinetic').

    ls: (nL, 3) lattice translations (host numpy); kpts: (nk, 3).
    Returns complex128 (nk, nao, nao)."""
    nao = meta.nao
    dev = params["atompos"].device
    kpts_t = torch.as_tensor(_np(kpts), dtype=DTYPE, device=dev)
    ls_t = torch.as_tensor(np.asarray(ls, dtype=np.float64), device=dev)
    phases = torch.exp(1j * (kpts_t @ ls_t.T))                  # (nk, nL)
    nk, nL = phases.shape
    out = torch.zeros((nk, nao * nao), dtype=torch.complex128, device=dev)
    for pc in tri_pair_classes(meta):
        inp = gather_pair_inputs(meta, params, pc)
        np_ = inp["A"].shape[0]
        # translations batched into the pair axis: (nL * np, ...)
        ext = {k: (inp[k].repeat(nL, 1) if k in ("A", "aa", "ab", "ca", "cb")
                   else inp[k]) for k in inp}
        ext["B"] = (inp["B"][None] + ls_t[:, None, :]).reshape(-1, 3)
        blk = _pair_block(kind, ext)
        blocks = blk.reshape(nL, np_, blk.shape[-2], blk.shape[-1])
        acc = torch.einsum("kl,lpab->kpab", phases,
                           blocks.to(torch.complex128))
        if pc.ca == pc.cb:
            diag = _const((pc.ia == pc.ib).astype(np.float64), blk)
            acc = acc * (1.0 - 0.5 * diag)[None, :, None, None]
        # one class writes each flat index once: the add is order-free
        idx = torch.as_tensor(pair_ao_indices(meta, pc).ravel(), device=dev)
        out = out.index_add(1, idx, acc.reshape(nk, -1))
    m = out.reshape(nk, nao, nao)
    # hermitian completion: S_k = A + A^H, A holding the canonical pairs
    return m + torch.conj(m.transpose(-1, -2))


def pbc_overlap(meta, params, ls, kpts):
    return pbc_int1e("overlap", meta, params, ls, kpts)


def pbc_kinetic(meta, params, ls, kpts):
    return pbc_int1e("kinetic", meta, params, ls, kpts)


def gamma_int1e(kind, meta, params, ls):
    """The real Gamma-point lattice sum (nao, nao) of pbc_int1e."""
    return pbc_int1e(kind, meta, params, ls, np.zeros((1, 3)))[0].real
