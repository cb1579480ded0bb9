"""Analytic Fourier transforms of AO pairs for periodic systems at the Gamma
point and at k-points (counterpart of dqc_tpu/ops/pbcft.py):

    F_ij(G) = sum_T <phi_i | e^{-i G.r} | phi_j(. - T)>
            = sum_prims w_k sum_h E_h^{ij} (-iG)^h (pi/p)^{3/2}
              e^{-G^2/(4p)} e^{-i G.P_k},

the Fourier transform of a Hermite Gaussian on the McMurchie-Davidson
factors of ops/eri.hermite_factor_pair. With a reciprocal-space Coulomb
kernel w_G they give the nuclear attraction, J and K of a periodic cell
(the AFT route), all differentiable in the atom positions and the basis
parameters. Everything is kept as real f64 pairs (re, im).

The G axis is cut into blocks whose temporaries take utils/config's
PBC_BLOCK_BYTES; under autograd each block is recomputed in the backward
(torch.utils.checkpoint) instead of keeping its temporaries, which
autograd would otherwise hold for every block. The sum over
the translations of one pair is a gather of the pair's contiguous run of
(pair, translation) terms and a sum over a fixed axis, in a fixed order,
so two builds give the same bits on the card. The Bloch transforms at
k-points (pbc_pair_plan_ordered, pbc_pair_ft_k) run over all ordered pairs
and weigh the same Hermite terms with the phases e^{ik.T} of each k.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..utils.config import DTYPE, block_bytes
from ..utils.datastruct import stack_members, tree_member
from .eri import hermite_factor_pair, hermite_factor_single
from .mcd import hermite_list
from .pbc import _np, estimate_rcut
from .shellstruct import (BasisMeta, all_pair_classes, gather_pair_inputs,
                          normalized_coeffs, nsph, pair_ao_indices,
                          tri_pair_classes)


def _blocked(fn, ng: int, gc: int, *args, remat: bool = False):
    """fn(g0, g1, *args) over the blocks [g0, g1) of the G axis; with
    `remat`, a block that autograd records is recomputed in the backward
    instead of keeping its temporaries."""
    remat = remat and torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)
    for g0 in range(0, ng, gc):
        g1 = min(ng, g0 + gc)
        if remat:
            yield g0, g1, checkpoint(fn, g0, g1, *args, use_reentrant=False)
        else:
            yield g0, g1, fn(g0, g1, *args)


def _g_block(per_g_bytes: float, ng: int, device) -> int:
    return int(max(1, min(ng, block_bytes(device) // max(per_g_bytes, 1))))


def gpow_table(L: int, Gv):
    """(-iG)^h for all Hermite indices |h| <= L. Gv: (ng, 3). Returns (Wre,
    Wim), each (ng, nh), with Wre + i Wim = (-iGx)^t (-iGy)^u (-iGz)^v."""
    hl = hermite_list(L)
    pows = [torch.ones_like(Gv)]
    for _ in range(L):
        pows.append(pows[-1] * Gv)
    P = torch.stack(pows, dim=-1)                   # (ng, 3, L+1)
    W = torch.stack([P[:, 0, t] * P[:, 1, u] * P[:, 2, v]
                     for (t, u, v) in hl], dim=-1)  # (ng, nh)
    # (-i)^{|h|} cycles through (1, 0), (0, -1), (-1, 0), (0, 1)
    cre = torch.as_tensor([[1.0, 0.0, -1.0, 0.0][sum(h) % 4] for h in hl],
                          dtype=Gv.dtype, device=Gv.device)
    cim = torch.as_tensor([[0.0, -1.0, 0.0, 1.0][sum(h) % 4] for h in hl],
                          dtype=Gv.dtype, device=Gv.device)
    return W * cre[None, :], W * cim[None, :]


def _ft_terms(H, p, P, L, Gc):
    """(re, im), each (nbatch, nsph, gc): the Fourier transforms at the G
    vectors Gc of Hermite factors H (nbatch, nprim, nsph, nh) with
    exponents p and centres P (nbatch, nprim[, 3])."""
    Wre, Wim = gpow_table(L, Gc)                      # (gc, nh)
    Tre = torch.einsum("pksh,gh->pksg", H, Wre)
    Tim = torch.einsum("pksh,gh->pksg", H, Wim)
    g2 = torch.sum(Gc * Gc, dim=-1)                   # (gc,)
    damp = ((math.pi / p[..., None]) ** 1.5
            * torch.exp(-g2[None, None, :] / (4.0 * p[..., None])))
    ph = torch.einsum("pkd,gd->pkg", P, Gc)
    c = (damp * torch.cos(ph))[:, :, None, :]
    s = (damp * torch.sin(ph))[:, :, None, :]
    fre = (c * Tre + s * Tim).sum(dim=1)
    fim = (c * Tim - s * Tre).sum(dim=1)
    return fre, fim


def _pair_plan(meta, params, lattice, precision, classes):
    rcut = estimate_rcut(meta, params, precision)
    ls = lattice.get_lattice_ls(rcut)
    pos = _np(params["atompos"])
    logp = -np.log(precision)
    plan = []
    for pc in classes:
        A_cls, B_cls = meta.classes[pc.ca], meta.classes[pc.cb]
        aa = _np(params["alphas"][pc.ca])[pc.ia].min(axis=1)
        ab = _np(params["alphas"][pc.cb])[pc.ib].min(axis=1)
        mu_min = aa * ab / (aa + ab)
        A = pos[np.asarray(A_cls.atom_ids)[pc.ia]]
        B = pos[np.asarray(B_cls.atom_ids)[pc.ib]]
        d2 = np.sum(((A - B)[:, None, :] - ls[None, :, :]) ** 2, axis=-1)
        q, t = np.nonzero(mu_min[:, None] * d2 < logp)
        plan.append((pc, q.astype(np.int64), ls[t]))
    return plan


def pbc_pair_plan(meta: BasisMeta, params, lattice, precision: float = 1e-9
                  ) -> List[Tuple[object, np.ndarray, np.ndarray]]:
    """Host-side plan: for each triangular pair class, the (pair q,
    translation T) terms whose Gaussian prefactor exp(-mu |A - B - T|^2)
    can exceed `precision` (mu of the most diffuse primitive pair).
    Returns [(pair_class, qidx (nsel,) ascending, shifts (nsel, 3)), ...]."""
    return _pair_plan(meta, params, lattice, precision,
                      tri_pair_classes(meta))


def pbc_pair_plan_ordered(meta: BasisMeta, params, lattice,
                          precision: float = 1e-9):
    """pbc_pair_plan over all ordered shell pairs (all_pair_classes): at k
    != 0 the two AO orders are independent, Q^k_ji != conj(Q^k_ij), so no
    symmetric completion is made."""
    return _pair_plan(meta, params, lattice, precision,
                      all_pair_classes(meta))


def _segments(qidx, npair):
    """(npair, maxc) positions of each pair's run of terms in the ascending
    qidx; missing slots point at index len(qidx) (a zero row)."""
    counts = np.bincount(qidx, minlength=npair)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    maxc = max(int(counts.max()), 1)
    slot = np.arange(maxc)[None, :]
    return np.where(slot < counts[:, None], starts[:, None] + slot, len(qidx))


def pbc_pair_ft(meta: BasisMeta, params, plan, Gv):
    """Gamma-point lattice-summed pair transforms over the G vectors Gv
    (host numpy, (ng, 3)). Returns (Fre, Fim), each (ng, nao, nao);
    complex-symmetric in (i, j) at Gamma. The symmetric completion is made
    per G block, so no second full-size tensor is formed."""
    nao = meta.nao
    dev = params["atompos"].device
    ng = Gv.shape[0]
    Gv_t = torch.as_tensor(np.asarray(Gv, dtype=np.float64), device=dev)
    classes = []
    per_g = 3.0 * nao * nao * 8
    for pc, qidx, shifts in plan:
        if len(qidx) == 0:
            continue
        inp = gather_pair_inputs(meta, params, pc)
        q = torch.as_tensor(qidx, device=dev)
        ext = {k: (inp[k][q] if k not in ("la", "lb") else inp[k])
               for k in inp}
        ext["B"] = ext["B"] + torch.as_tensor(shifts, dtype=DTYPE,
                                              device=dev)
        bra = hermite_factor_pair(ext)
        seg = torch.as_tensor(_segments(qidx, pc.npair), device=dev)
        half = None
        if pc.ca == pc.cb:
            half = torch.as_tensor(1.0 - 0.5 * (pc.ia == pc.ib), dtype=DTYPE,
                                   device=dev)[:, None, None]
        idx = torch.as_tensor(pair_ao_indices(meta, pc).ravel(), device=dev)
        classes.append((bra, seg, half, idx))
        ns, kk, nsp, nh = bra.H.shape
        per_g += 8.0 * (ns * kk * (2 * nsp * nh + 6 * nsp + 4)
                        + 2 * seg.numel() * nsp)
    gc = _g_block(per_g, ng, dev)

    def block(g0, g1, *factors):
        Gc = Gv_t[g0:g1]
        out = [torch.zeros((nao * nao, g1 - g0), dtype=DTYPE, device=dev)
               for _ in range(2)]
        for ci, (bra, seg, half, idx) in enumerate(classes):
            H, p, P = factors[3 * ci:3 * ci + 3]
            for acc, f in zip(out, _ft_terms(H, p, P, bra.L, Gc)):
                f = torch.cat([f, torch.zeros_like(f[:1])])[seg].sum(dim=1)
                if half is not None:
                    f = f * half
                # one class writes each flat index once: order-free
                acc.index_add_(0, idx, f.reshape(-1, g1 - g0))
        return tuple((a.view(nao, nao, -1) + a.view(nao, nao, -1)
                      .transpose(0, 1)).permute(2, 0, 1) for a in out)

    factors = [t for bra, _, _, _ in classes for t in (bra.H, bra.p, bra.P)]
    Fre = torch.empty((ng, nao, nao), dtype=DTYPE, device=dev)
    Fim = torch.empty((ng, nao, nao), dtype=DTYPE, device=dev)
    for g0, g1, (fre, fim) in _blocked(block, ng, gc, *factors,
                                        remat=True):
        Fre[g0:g1] = fre
        Fim[g0:g1] = fim
    return Fre, Fim


def pbc_pair_ft_k(meta: BasisMeta, params, plan, Gv, kpts):
    """Bloch pair transforms over the G vectors Gv (host numpy, (ng, 3)) at
    the k-points kpts (host numpy, (nk, 3)):

        Q^k_ij(G) = sum_T e^{ik.T} <phi_i | e^{-iG.r} | phi_j(. - T)>,

    plan from pbc_pair_plan_ordered. Returns (Qre, Qim), each (nk, ng, nao,
    nao). Per G block the Hermite transforms of the (pair, translation)
    terms are formed once; each k then weighs them with its phases e^{ik.T}
    and sums every pair's run of terms by a gather over a fixed axis, so
    two builds give the same bits. Gv may be any vector set (the exchange
    stack passes q + G)."""
    nao = meta.nao
    dev = params["atompos"].device
    ng, nk = Gv.shape[0], len(kpts)
    Gv_t = torch.as_tensor(np.asarray(Gv, dtype=np.float64), device=dev)
    kpts = np.asarray(kpts, dtype=np.float64).reshape(nk, 3)
    classes = []
    per_g = 4.0 * nk * nao * nao * 8
    for pc, qidx, shifts in plan:
        if len(qidx) == 0:
            continue
        inp = gather_pair_inputs(meta, params, pc)
        q = torch.as_tensor(qidx, device=dev)
        ext = {k: (inp[k][q] if k not in ("la", "lb") else inp[k])
               for k in inp}
        ext["B"] = ext["B"] + torch.as_tensor(shifts, dtype=DTYPE,
                                              device=dev)
        bra = hermite_factor_pair(ext)
        seg = _segments(qidx, pc.npair)
        # the phases of each pair's run of terms; the padding slot's are 0
        kdot = np.concatenate([kpts @ shifts.T, np.zeros((nk, 1))], axis=1)
        pad = np.concatenate([np.ones(len(qidx)), [0.0]])
        ph = [torch.as_tensor((f(kdot) * pad)[:, seg], dtype=DTYPE,
                              device=dev) for f in (np.cos, np.sin)]
        idx = torch.as_tensor(pair_ao_indices(meta, pc).ravel(), device=dev)
        classes.append((bra, torch.as_tensor(seg, device=dev), ph, idx))
        ns, kk, nsp, nh = bra.H.shape
        per_g += 8.0 * (ns * kk * (2 * nsp * nh + 6 * nsp + 4)
                        + 6 * seg.size * nsp)
    gc = _g_block(per_g, ng, dev)

    def block(g0, g1, *factors):
        Gc = Gv_t[g0:g1]
        out = [torch.zeros((nk, nao * nao, g1 - g0), dtype=DTYPE,
                           device=dev) for _ in range(2)]
        for ci, (bra, seg, (ck, sk), idx) in enumerate(classes):
            H, p, P = factors[3 * ci:3 * ci + 3]
            fre, fim = (torch.cat([f, torch.zeros_like(f[:1])])[seg]
                        for f in _ft_terms(H, p, P, bra.L, Gc))
            for k in range(nk):
                c = ck[k][:, :, None, None]
                s = sk[k][:, :, None, None]
                # e^{ik.T} (fre + i fim), summed over each pair's terms;
                # one class writes each flat index once: order-free
                out[0][k].index_add_(0, idx, (c * fre - s * fim).sum(
                    dim=1).reshape(-1, g1 - g0))
                out[1][k].index_add_(0, idx, (c * fim + s * fre).sum(
                    dim=1).reshape(-1, g1 - g0))
        return tuple(a.view(nk, nao, nao, -1).permute(0, 3, 1, 2)
                     for a in out)

    factors = [t for bra, _, _, _ in classes for t in (bra.H, bra.p, bra.P)]
    Qre = torch.empty((nk, ng, nao, nao), dtype=DTYPE, device=dev)
    Qim = torch.empty((nk, ng, nao, nao), dtype=DTYPE, device=dev)
    for g0, g1, (qre, qim) in _blocked(block, ng, gc, *factors, remat=True):
        Qre[:, g0:g1] = qre
        Qim[:, g0:g1] = qim
    return Qre, Qim


def coulomb_gweights(Gv, volume):
    """w_G = 4 pi / (V G^2), the G = 0 term dropped (the jellium convention;
    the matching background terms are in the Ewald nuclei energy)."""
    g2 = torch.sum(torch.as_tensor(Gv, dtype=DTYPE,
                                   device=volume.device) ** 2, dim=-1)
    nz = g2 > 1e-12
    return torch.where(nz, 4.0 * math.pi / (volume * torch.where(
        nz, g2, torch.ones_like(g2))), torch.zeros_like(g2))


def coulomb_gweights_sr(Gv, volume, omega):
    """G weights of the short-range erfc(omega r)/r kernel: w_G = 4 pi (1 -
    e^{-G^2/(4 omega^2)}) / (V G^2), and its finite G -> 0 limit pi /
    (omega^2 V), which is kept (no jellium drop, no Madelung term)."""
    om2 = float(omega) ** 2
    g2 = torch.sum(torch.as_tensor(Gv, dtype=DTYPE,
                                   device=volume.device) ** 2, dim=-1)
    nz = g2 > 1e-12
    g2s = torch.where(nz, g2, torch.ones_like(g2))
    return torch.where(nz, 4.0 * math.pi * -torch.expm1(-g2s / (4.0 * om2))
                       / (volume * g2s), math.pi / (om2 * volume)
                       * torch.ones_like(g2))


def aft_k_weighted(pbcft_theta, dm, w):
    """K = sum_G w_G (R_G dm R_G^T + I_G dm I_G^T), F = R + iI, for dm (n,
    n) or (2, n, n); no divergence correction. The G axis is cut into
    blocks, so the (ng, n, n) products R_G dm are never whole. A batch
    (Fre (B, ng, n, n), w (B, ng), dm (B, [2,] n, n)) member by member."""
    if pbcft_theta["Fre"].ndim == 4:
        return stack_members([
            aft_k_weighted(tree_member(pbcft_theta, m), dm[m], w[m])
            for m in range(dm.shape[0])])
    if dm.ndim == 3:
        return torch.stack([aft_k_weighted(pbcft_theta, d, w) for d in dm])
    R, I = pbcft_theta["Fre"], pbcft_theta["Fim"]
    ng, n = R.shape[0], R.shape[-1]
    w = w.to(dm.dtype)
    gc = _g_block(5.0 * n * n * 8, ng, dm.device)

    def block(g0, g1, R, I, dm, w):
        k = 0.0
        for F in (R[g0:g1], I[g0:g1]):
            t = torch.matmul(F, dm) * w[g0:g1, None, None]     # (gc, n, n)
            k = k + (t.permute(1, 0, 2).reshape(n, -1)
                     @ F.permute(1, 0, 2).reshape(n, -1).T)
        return k

    out = 0.0
    for _, _, k in _blocked(block, ng, gc, R, I, dm, w):
        out = out + k
    return out


def aft_j(pbcft_theta, dm):
    """J_ij = sum_G w_G Re[rho(G) conj(F_ij(G))], rho(G) = sum_kl dm_kl
    F_kl(G). A batch (Fre (B, ng, n, n), dm (B, n, n)) member by
    member."""
    Fre, Fim, w = (pbcft_theta["Fre"], pbcft_theta["Fim"],
                   pbcft_theta["wcoul"])
    if Fre.ndim == 4:
        return stack_members([aft_j(tree_member(pbcft_theta, m), dm[m])
                              for m in range(dm.shape[0])])
    ng, n = Fre.shape[0], Fre.shape[-1]
    fre, fim = Fre.reshape(ng, n * n), Fim.reshape(ng, n * n)
    d = dm.reshape(n * n)
    return ((w * (fre @ d)) @ fre + (w * (fim @ d)) @ fim).reshape(n, n)


def aft_k(theta, dm):
    """Gamma-point exact exchange from the pair transforms: with (ij|kl) =
    sum_G w_G conj(F_ij(G)) F_kl(G), K = sum_G w_G (R_G dm R_G + I_G dm I_G).
    The dropped G = 0 term is restored by the probe-charge Ewald (Madelung)
    correction K += M S dm S, M = theta['pbcft']['madelung'] (exxdiv
    'ewald'; None for exxdiv None). dm (n, n) or (2, n, n); a batch
    (theta's tensors (B, ...), dm (B, [2,] n, n)) member by member."""
    p = theta["pbcft"]
    if p["Fre"].ndim == 4:
        th = {"pbcft": p, "ovlp": theta["ovlp"]}
        return stack_members([aft_k(tree_member(th, m), dm[m])
                              for m in range(dm.shape[0])])
    k = aft_k_weighted(p, dm, p["wcoul"])
    mad = p.get("madelung")
    if mad is not None:
        s = theta["ovlp"]
        k = k + mad * torch.einsum("ik,...kl,lj->...ij", s, dm, s)
    return k


def aft_vnuc(Fre, Fim, w, atomzs, atompos, Gv):
    """Nuclear attraction from point nuclei in G space: Vne_ij = sum_G w_G
    Re[n(G) conj(F_ij(G))], n(G) = -sum_A Z_A e^{-i G.R_A}."""
    ng, n = Fre.shape[0], Fre.shape[-1]
    gv = torch.as_tensor(np.asarray(Gv, dtype=np.float64),
                         device=atompos.device)
    ph = gv @ atompos.T                                   # (ng, natm)
    z = torch.as_tensor(atomzs, dtype=DTYPE, device=atompos.device)
    nr = -(torch.cos(ph) @ z)
    ni = torch.sin(ph) @ z
    return ((w * nr) @ Fre.reshape(ng, n * n)
            + (w * ni) @ Fim.reshape(ng, n * n)).reshape(n, n)


def gcut_estimate(meta, params, precision: float = 1e-9) -> float:
    """G cutoff at which the steepest pair's tail e^{-G^2/(4 p_max)} falls
    below `precision`."""
    amax = max(float(np.max(_np(a))) for a in params["alphas"])
    return float(np.sqrt(8.0 * amax * -np.log(precision)))


def eval_ao_ft(meta: BasisMeta, params, Gv):
    """Fourier transforms of single AOs, phi_i(G) = int e^{-iG.r} phi_i(r)
    dr, on the G vectors Gv (numpy or tensor, (ng, 3)). Returns (re, im),
    each (ng, nao)."""
    dev = params["atompos"].device
    Gv_t = torch.as_tensor(_np(Gv).astype(np.float64), device=dev)
    ng = Gv_t.shape[0]
    facs, cols = [], []
    for ci, cls in enumerate(meta.classes):
        pos = params["atompos"][torch.as_tensor(
            np.asarray(cls.atom_ids, dtype=np.int64), device=dev)]
        coeffs = normalized_coeffs(cls.l, params["alphas"][ci],
                                   params["coeffs"][ci], params["mask"][ci])
        facs.append(hermite_factor_single(cls.l, pos, params["alphas"][ci],
                                          coeffs))
        cols.append((np.asarray(cls.ao_starts)[:, None]
                     + np.arange(nsph(cls.l))[None, :]).ravel())
    perm = np.empty(meta.nao, dtype=np.int64)
    perm[np.concatenate(cols)] = np.arange(meta.nao)
    perm = torch.as_tensor(perm, device=dev)
    per_g = 8.0 * sum(f.H.shape[0] * f.H.shape[1] * (2 * f.H.shape[3] + 8)
                      for f in facs) + 16.0 * meta.nao
    gc = _g_block(per_g, ng, dev)

    def block(g0, g1, *tensors):
        re, im = [], []
        for i, f in enumerate(facs):
            H, p, P = tensors[3 * i:3 * i + 3]
            fre, fim = _ft_terms(H, p, P, f.L, Gv_t[g0:g1])
            re.append(fre.reshape(-1, g1 - g0))
            im.append(fim.reshape(-1, g1 - g0))
        return (torch.cat(re)[perm].T, torch.cat(im)[perm].T)

    tensors = [t for f in facs for t in (f.H, f.p, f.P)]
    blocks = list(_blocked(block, ng, gc, *tensors))
    return (torch.cat([b[2][0] for b in blocks]),
            torch.cat([b[2][1] for b in blocks]))
