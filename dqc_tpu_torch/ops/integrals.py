"""One-electron molecular integrals (overlap, kinetic, nuclear, multipole).

Counterpart of dqc_tpu/ops/integrals.py: plain tensor code over
class-batched shell pairs, with precomputed-index gathers instead of
per-component loops. torch.autograd provides derivatives.

Public functions take (meta, params) from ops.shellstruct.pack_basis:
  overlap(meta, params)            -> (nao, nao)
  kinetic(meta, params)            -> (nao, nao)
  nuclattr(meta, params, atomzs, atompos_nuc=None) -> (nao, nao)
  rinv(meta, params, center)       -> (nao, nao)   [1/|r-C| integrals]
  multipole(meta, params, (ex,ey,ez), center) -> (nao, nao)
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..utils.config import DTYPE
from .chunks import map_blocks
from .mcd import (_cart_components, e3_pair, e_coeffs_stacked,
                  gaussian_product, hermite_R_stacked, hermite_multipole)
from .shellstruct import (BasisMeta, gather_pair_inputs, pair_ao_indices,
                          sph_transform, tri_pair_classes)

__all__ = ["overlap", "kinetic", "nuclattr", "rinv", "multipole"]


def _const(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _sph_pair(blk, la, lb):
    """(np, ncart_a, ncart_b) -> (np, 2la+1, 2lb+1)."""
    Ca = _const(sph_transform(la), blk)
    Cb = _const(sph_transform(lb), blk)
    return torch.einsum("pab,ma,nb->pmn", blk, Ca, Cb)


def _assemble(meta: BasisMeta, params, pair_fn):
    """Assemble a symmetric (nao, nao) matrix from per-pair-class blocks.

    pair_fn(inp) -> (np, nsph_a, nsph_b) for the pair inputs of one class.
    Inside one pair class every flat index occurs once, so each index_add
    is order-independent also where the device adds with atomics."""
    dev = params["atompos"].device
    out = torch.zeros((meta.nao * meta.nao,), dtype=DTYPE, device=dev)
    for pc in tri_pair_classes(meta):
        inp = gather_pair_inputs(meta, params, pc)
        blk = pair_fn(inp)
        # halve diagonal (ia == ib, same class) blocks: the final
        # symmetrization out + out.T doubles them back.
        if pc.ca == pc.cb:
            diag = _const((pc.ia == pc.ib).astype(np.float64), blk)
            blk = blk * (1.0 - 0.5 * diag)[:, None, None]
        idx = torch.as_tensor(pair_ao_indices(meta, pc).ravel(), device=dev)
        out = out.index_add(0, idx, blk.reshape(-1))
    m = out.reshape(meta.nao, meta.nao)
    return m + m.T


def _e0_gather_indices(la: int, lb: int, lb_pad: int, shift: int = 0):
    """Index map (3, ncart_a*ncart_b) into the flattened (la+1, lb_pad+1)
    t=0 slice of the E table for E[0, pa_d, pb_d + shift], and a 0/1 mask
    that zeroes invalid (pb+shift > lb_pad or < 0) entries."""
    ca_l, cb_l = _cart_components(la), _cart_components(lb)
    idx = np.zeros((3, len(ca_l) * len(cb_l)), dtype=np.int64)
    ok = np.ones((3, len(ca_l) * len(cb_l)), dtype=np.float64)
    for d in range(3):
        for i, pa in enumerate(ca_l):
            for j, pb in enumerate(cb_l):
                jj = pb[d] + shift
                c = i * len(cb_l) + j
                if 0 <= jj <= lb_pad:
                    idx[d, c] = pa[d] * (lb_pad + 1) + jj
                else:
                    idx[d, c] = 0
                    ok[d, c] = 0.0
    return idx, ok


def _gather_e0(Earr, la, lb, lb_pad, shift=0):
    """Earr: (..., 3, T, la+1, lb_pad+1) -> 3 tensors (..., ncart_ab) of
    E[0, pa_d, pb_d+shift] (zero where invalid)."""
    idx, ok = _e0_gather_indices(la, lb, lb_pad, shift)
    t0 = Earr[..., 0, :, :]                       # (..., 3, la+1, lb_pad+1)
    flat = t0.reshape(t0.shape[:-2] + (-1,))      # (..., 3, N)
    outs = []
    for d in range(3):
        i_d = torch.as_tensor(idx[d], device=Earr.device)
        outs.append(flat[..., d, :][..., i_d] * _const(ok[d], Earr))
    return outs


def _pair_weights(inp, gp):
    return (inp["ca"][:, :, None] * inp["cb"][:, None, :] * gp["pref"]
            * (math.pi / gp["p"]) ** 1.5)


def _pair_overlap_cart(inp):
    la, lb = inp["la"], inp["lb"]
    gp = gaussian_product(la, lb, inp["A"], inp["B"], inp["aa"], inp["ab"])
    Earr = e_coeffs_stacked(la, lb, gp["PA"], gp["PB"], gp["inv2p"])
    Ex, Ey, Ez = _gather_e0(Earr, la, lb, lb)
    blk = torch.einsum("pabc,pab->pc", Ex * Ey * Ez, _pair_weights(inp, gp))
    return blk.reshape(blk.shape[0], (la + 1) * (la + 2) // 2, -1)


def overlap(meta, params):
    def fn(inp):
        return _sph_pair(_pair_overlap_cart(inp), inp["la"], inp["lb"])
    return _assemble(meta, params, fn)


def kinetic(meta, params):
    """T = -1/2 <a|lapl|b> via the 1D shifted-overlap formula:
    T1d_ij = b(2j+1) S_ij - 2 b^2 S_{i,j+2} - j(j-1)/2 S_{i,j-2}."""
    def fn(inp):
        la, lb = inp["la"], inp["lb"]
        nca = (la + 1) * (la + 2) // 2
        gp = gaussian_product(la, lb, inp["A"], inp["B"], inp["aa"], inp["ab"])
        Earr = e_coeffs_stacked(la, lb + 2, gp["PA"], gp["PB"], gp["inv2p"])
        S0 = _gather_e0(Earr, la, lb, lb + 2, 0)
        Sp2 = _gather_e0(Earr, la, lb, lb + 2, +2)
        Sm2 = _gather_e0(Earr, la, lb, lb + 2, -2)
        cb_l = _cart_components(lb)
        ca_l = _cart_components(la)
        jpow = _const(np.array([[pb[d] for pa in ca_l for pb in cb_l]
                                for d in range(3)], dtype=np.float64),
                      Earr)                                    # (3, ncab)
        b = inp["ab"][:, None, :, None]  # (np,1,kb,1)
        K = [b * (2 * jpow[d] + 1) * S0[d] - 2.0 * b * b * Sp2[d]
             - 0.5 * jpow[d] * (jpow[d] - 1) * Sm2[d] for d in range(3)]
        v = (K[0] * S0[1] * S0[2] + S0[0] * K[1] * S0[2]
             + S0[0] * S0[1] * K[2])
        blk = torch.einsum("pabc,pab->pc", v, _pair_weights(inp, gp))
        blk = blk.reshape(blk.shape[0], nca, -1)
        return _sph_pair(blk, la, lb)
    return _assemble(meta, params, fn)


def _pair_coulomb_point(inp, centers, charges, block=128):
    """<a| sum_C q_C / |r - C| |b> for one pair class.

    centers: (nc, 3), charges: (nc,) — signed (pass -Z for nuclear
    attraction, +1 for rinv)."""
    la, lb = inp["la"], inp["lb"]
    lab = la + lb
    nca = (la + 1) * (la + 2) // 2

    def body(blk_inp):
        gp = gaussian_product(la, lb, blk_inp["A"], blk_inp["B"],
                              blk_inp["aa"], blk_inp["ab"])
        Earr = e_coeffs_stacked(la, lb, gp["PA"], gp["PB"], gp["inv2p"])
        E3 = e3_pair(la, lb, Earr)                    # (np,ka,kb,ncab,nh)
        p = gp["p"]
        PC = gp["P"][..., None, :] - centers          # (np,ka,kb,nc,3)
        Rarr = hermite_R_stacked(lab, p[..., None], PC)  # (np,ka,kb,nc,nh)
        Rq = torch.einsum("pabch,c->pabh", Rarr, charges)
        w = (blk_inp["ca"][:, :, None] * blk_inp["cb"][:, None, :]
             * gp["pref"] * (2.0 * math.pi / p))
        return torch.einsum("pabch,pabh,pab->pc", E3, Rq, w)

    n = inp["A"].shape[0]
    args = {k: inp[k] for k in ("A", "B", "aa", "ab", "ca", "cb")}
    blk = map_blocks(body, args, n, block)
    return _sph_pair(blk.reshape(n, nca, -1), la, lb)


def nuclattr(meta, params, atomzs, atompos_nuc=None):
    """Nuclear attraction <a| sum_A -Z_A/|r-R_A| |b>. atomzs may be
    fractional and differentiable."""
    centers = params["atompos"] if atompos_nuc is None else atompos_nuc
    charges = -_const(atomzs, centers)

    def fn(inp):
        return _pair_coulomb_point(inp, centers, charges)
    return _assemble(meta, params, fn)


def rinv(meta, params, center):
    """<a| 1/|r - C| |b> for a single center C (3,)."""
    centers = _const(center, params["atompos"])[None, :]
    charges = torch.ones((1,), dtype=DTYPE, device=centers.device)

    def fn(inp):
        return _pair_coulomb_point(inp, centers, charges)
    return _assemble(meta, params, fn)


def multipole(meta, params, powers: Tuple[int, int, int], center=None):
    """<a| (x-Cx)^ex (y-Cy)^ey (z-Cz)^ez |b>."""
    pw = tuple(powers)
    pos = params["atompos"]
    c = (torch.zeros((3,), dtype=DTYPE, device=pos.device) if center is None
         else _const(center, pos))

    def fn(inp):
        la, lb = inp["la"], inp["lb"]
        nca = (la + 1) * (la + 2) // 2
        gp = gaussian_product(la, lb, inp["A"], inp["B"], inp["aa"], inp["ab"])
        Earr = e_coeffs_stacked(la, lb, gp["PA"], gp["PB"], gp["inv2p"])
        T = la + lb + 1
        n_ab = (la + 1) * (lb + 1)
        flat = Earr.reshape(Earr.shape[:-3] + (T * n_ab,))
        PC = gp["P"] - c
        M = hermite_multipole(max(pw), la + lb, PC, gp["inv2p"])
        ca_l, cb_l = _cart_components(la), _cart_components(lb)
        ncab = len(ca_l) * len(cb_l)
        dims = []
        for d in range(3):
            acc = 0.0
            for t in range(min(la + lb, pw[d]) + 1):
                idx = np.zeros((ncab,), dtype=np.int64)
                for i, pa in enumerate(ca_l):
                    for j, pb in enumerate(cb_l):
                        idx[i * len(cb_l) + j] = (t * n_ab
                                                  + pa[d] * (lb + 1) + pb[d])
                i_t = torch.as_tensor(idx, device=flat.device)
                Et = flat[..., d, :][..., i_t]        # (np,ka,kb,ncab)
                acc = acc + Et * M[(pw[d], t)][..., d:d + 1]
            dims.append(acc)
        w = inp["ca"][:, :, None] * inp["cb"][:, None, :] * gp["pref"]
        blk = torch.einsum("pabc,pab->pc", dims[0] * dims[1] * dims[2], w)
        return _sph_pair(blk.reshape(blk.shape[0], nca, -1), la, lb)
    return _assemble(meta, params, fn)
