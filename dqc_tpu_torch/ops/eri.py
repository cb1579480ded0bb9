"""Electron-repulsion integrals: 4-center dense, and the 3- and 2-center
Coulomb integrals of density fitting.

Counterpart of dqc_tpu/ops/eri.py. Design:

  - every charge distribution (shell pair, or single aux shell) is reduced
    to a *Hermite factor*
    H[batch, prims, nsph, nherm]: the contraction- and spherical-transformed
    McMurchie-Davidson E-coefficients, assembled with precomputed-index
    gathers.
  - (bra|1/r12|ket) is a bilinear form through the Hermite Coulomb matrix R
    built from Boys functions — batched tensor contractions.
  - 8-fold permutation symmetry: canonical shell-pair quartets only, then 3
    transpose symmetrizations.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
# checkpoint imports torch._dynamo on its first call, and that import runs
# torch.fx's wrap(), which keeps its own frame in a local: a cycle whose
# f_back chain holds every frame below it until the cyclic garbage collector
# runs. Made inside a gradient, the import would pin the caller's frames and
# with them the calc; made here, it holds only import frames.
import torch._dynamo  # noqa: F401
from torch.utils.checkpoint import checkpoint

from ..utils.config import DTYPE, config
from .chunks import map_blocks
from .mcd import (e3_pair, e_coeffs_stacked, gaussian_product, hermite_list,
                  hermite_R_stacked)
from .shellstruct import (BasisMeta, PairClassMeta, gather_pair_inputs,
                          normalized_coeffs, nsph, pair_ao_indices,
                          sph_transform, tri_pair_classes)

TWO_PI_POW_2_5 = 2.0 * np.pi ** 2.5


@dataclass
class HermiteFactor:
    """A charge distribution expanded in Hermite gaussians.

    H: (nbatch, nprim, nsph, nherm) — contraction coeffs folded in
    p: (nbatch, nprim) exponents; P: (nbatch, nprim, 3) centers
    L: total angular momentum of the expansion
    """
    H: torch.Tensor
    p: torch.Tensor
    P: torch.Tensor
    L: int


def hermite_factor_pair(inp) -> HermiteFactor:
    """Hermite factor of a shell-pair class (bra or ket of 4c integrals)."""
    la, lb = inp["la"], inp["lb"]
    L = la + lb
    gp = gaussian_product(la, lb, inp["A"], inp["B"], inp["aa"], inp["ab"])
    Earr = e_coeffs_stacked(la, lb, gp["PA"], gp["PB"], gp["inv2p"])
    E3 = e3_pair(la, lb, Earr)                       # (np,ka,kb,ncab,nh)
    w = inp["ca"][:, :, None] * inp["cb"][:, None, :] * gp["pref"]
    Hcart = E3 * w[..., None, None]
    np_, ka, kb = w.shape
    nh = E3.shape[-1]
    Hcart = Hcart.reshape(np_, ka * kb, -1, nh)
    Csph = torch.as_tensor(np.kron(sph_transform(la), sph_transform(lb)),
                           dtype=Hcart.dtype, device=Hcart.device)
    H = torch.einsum("pkch,sc->pksh", Hcart, Csph)
    return HermiteFactor(H=H, p=gp["p"].reshape(np_, ka * kb),
                         P=gp["P"].reshape(np_, ka * kb, 3), L=L)


def hermite_factor_single(l: int, pos, alphas, coeffs) -> HermiteFactor:
    """Hermite factor of single shells (the aux side of DF integrals).

    pos: (ns,3); alphas/coeffs: (ns,k), coeffs already normalized+masked."""
    ns, k = alphas.shape
    zeros3 = torch.zeros((ns, k, 3), dtype=alphas.dtype, device=alphas.device)
    Earr = e_coeffs_stacked(l, 0, zeros3, zeros3, 0.5 / alphas)
    E3 = e3_pair(l, 0, Earr)                         # (ns,k,ncart,nh)
    Hcart = E3 * coeffs[..., None, None]
    Csph = torch.as_tensor(sph_transform(l), dtype=Hcart.dtype,
                           device=Hcart.device)
    H = torch.einsum("pkch,sc->pksh", Hcart, Csph)
    P = pos[:, None, :].expand(ns, k, 3)
    return HermiteFactor(H=H, p=alphas, P=P, L=l)


def _combine_index_sign(L1: int, L2: int):
    """IM[h1, h2] = index of h1+h2 in hermite_list(L1+L2); sign[h2]=(-1)^|h2|."""
    hl1, hl2 = hermite_list(L1), hermite_list(L2)
    pos = {h: i for i, h in enumerate(hermite_list(L1 + L2))}
    IM = np.zeros((len(hl1), len(hl2)), dtype=np.int64)
    for i, h1 in enumerate(hl1):
        for j, h2 in enumerate(hl2):
            IM[i, j] = pos[(h1[0] + h2[0], h1[1] + h2[1], h1[2] + h2[2])]
    sign = np.array([(-1.0) ** sum(h) for h in hl2])
    return IM, sign


def _auto_block(n, k1, q, k2, nht, nh1, nsph_k):
    """Bra rows per block such that the Hermite-R intermediates of one block
    — the (B,K1,Q,K2,nht) stack, about three times as many recursion
    temporaries, and the (B,K1,Q,nh1,nsph) half-contracted tensor — are
    about config.ERI_R_BYTES (copies made inside einsum/bmm come on top)."""
    per_row = 8 * k1 * q * (k2 * (4 * nht + 8) + nh1 * nsph_k)
    return int(max(1, min(n, config.ERI_R_BYTES // max(per_row, 1))))


def coulomb_contract(bra: HermiteFactor, ket: HermiteFactor, block=None,
                     omega=None):
    """out[b_batch, b_sph, k_batch, k_sph] = (bra | g(r12) | ket).

    g = 1/r12 (omega=None) or the long-range erf(omega*r12)/r12 kernel:
    two Gaussian charge distributions with composite exponents p1, p2
    interact through erf(w r)/r exactly as through 1/r with the reduced
    exponent theta = p1 p2/(p1+p2) replaced by theta*s and the Boys base
    scaled by sqrt(s), where s = w^2/(w^2 + theta).

    Chunked over the bra batch axis to bound the Hermite-R memory (`block`
    rows at a time; None picks the block from config.ERI_R_BYTES). The
    R_{H+G} index combination is folded into the ket factor once, by
    indexing: W[q,l,IM[H,G],H,c] = sign[G] ket.H[q,l,c,G]. For a fixed H the
    targets IM[H,G] are distinct, so no two entries collide."""
    Ltot = bra.L + ket.L
    IM, sign = _combine_index_sign(bra.L, ket.L)
    nh1, nh2 = IM.shape
    nht = len(hermite_list(Ltot))
    dev = ket.H.device
    nq, nl, nc, _ = ket.H.shape
    target = torch.as_tensor(
        (IM * nh1 + np.arange(nh1)[:, None]).ravel(), device=dev)   # (H,G)
    vals = ket.H * torch.as_tensor(sign, dtype=ket.H.dtype, device=dev)
    vals = vals.permute(0, 1, 3, 2)                                 # (q,l,G,c)
    vals = vals[:, :, None, :, :].expand(nq, nl, nh1, nh2, nc)
    W = torch.zeros((nq, nl, nht * nh1, nc), dtype=ket.H.dtype, device=dev)
    W = W.index_add(2, target, vals.reshape(nq, nl, nh1 * nh2, nc))
    W = W.reshape(nq, nl * nht, nh1 * nc)                           # (q,lt,Hc)

    def body(args):
        Hb, pb, Pb = args["H"], args["p"], args["P"]
        p1 = pb[:, :, None, None]
        p2 = ket.p[None, None, :, :]
        theta = p1 * p2 / (p1 + p2)
        PQ = tuple(Pb[:, :, None, None, d] - ket.P[None, None, :, :, d]
                   for d in range(3))
        pref = TWO_PI_POW_2_5 / (p1 * p2 * torch.sqrt(p1 + p2))
        if omega is not None:
            s = omega * omega / (omega * omega + theta)
            theta = theta * s
            pref = pref * torch.sqrt(s)
        Rs = hermite_R_stacked(Ltot, theta, PQ, scale=pref)  # (B,K1,Q,K2,nht)
        nb, k1 = Rs.shape[0], Rs.shape[1]
        # T1[q, (b,k), (H,c)] = sum_{l,t} Rs[b,k,q,l,t] W[q,(l,t),(H,c)]
        Rq = Rs.permute(2, 0, 1, 3, 4).reshape(nq, nb * k1, nl * nht)
        T1 = torch.bmm(Rq, W).reshape(nq, nb, k1, nh1, nc)
        return torch.einsum("bkaH,qbkHc->baqc", Hb, T1)

    n = bra.H.shape[0]
    if block is None:
        block = _auto_block(n, bra.H.shape[1], nq, nl, nht, nh1, nc)
    fn = body
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (bra.H, bra.p, bra.P, W, ket.p, ket.P)):
        # under autograd each block is recomputed in the backward instead of
        # keeping its Hermite-R graph: kept, the graphs of benzene/def2-SVP
        # would hold the whole 17.6 GB R stack and its recursion temporaries
        def fn(args):
            return checkpoint(body, args, use_reentrant=False)
    return map_blocks(fn, {"H": bra.H, "p": bra.p, "P": bra.P}, n, block)


def schwarz_bounds(meta: BasisMeta, params, block: int = 64):
    """Per-pair Schwarz bounds Q_ab = sqrt(max_mn (ab|ab)_{mn,mn}) for every
    tri pair class. Returns list of (npair,) tensors."""
    out = []
    for pc in tri_pair_classes(meta):
        inp = gather_pair_inputs(meta, params, pc)
        fac = hermite_factor_pair(inp)
        IM, sign = _combine_index_sign(fac.L, fac.L)
        dev = fac.H.device
        IMt = torch.as_tensor(IM, device=dev)
        Hk = fac.H * torch.as_tensor(sign, dtype=fac.H.dtype, device=dev)

        def body(args):
            Hb, pb, Pb, Hkk = args["H"], args["p"], args["P"], args["Hk"]
            p1 = pb[:, :, None]
            p2 = pb[:, None, :]
            theta = p1 * p2 / (p1 + p2)
            PQ = Pb[:, :, None, :] - Pb[:, None, :, :]
            Rarr = hermite_R_stacked(2 * fac.L, theta, PQ)
            pref = TWO_PI_POW_2_5 / (p1 * p2 * torch.sqrt(p1 + p2))
            M = Rarr[..., IMt] * pref[..., None, None]  # (p,K,K,nh,nh)
            v = torch.einsum("pkaH,pklHG,plbG->pab", Hb, M, Hkk)
            return torch.sqrt(torch.clamp(
                torch.amax(torch.abs(v), dim=(-1, -2)), min=1e-300))

        n = fac.H.shape[0]
        q = map_blocks(body, {"H": fac.H, "p": fac.p, "P": fac.P, "Hk": Hk},
                       n, block)
        out.append(q)
    return out


def prune_pairs(q: np.ndarray, qmax: float, thresh: float):
    """Indices of pairs surviving Schwarz screening."""
    return np.nonzero(q * qmax >= thresh)[0].astype(np.int32)


def screened_pair_classes(meta: BasisMeta, params, thresh: float = 1e-12):
    """Tri pair classes pruned by Schwarz screening (host-side; the pruning
    pattern is computed once from concrete params and then frozen)."""
    with torch.no_grad():
        qs = [q.cpu().numpy() for q in schwarz_bounds(meta, params)]
    qmax = max(float(q.max()) for q in qs)
    out = []
    for pc, q in zip(tri_pair_classes(meta), qs):
        keep = prune_pairs(q, qmax, thresh)
        out.append((PairClassMeta(ca=pc.ca, cb=pc.cb,
                                  ia=pc.ia[keep], ib=pc.ib[keep]), q[keep]))
    return out


def eri_dense(meta: BasisMeta, params, block=None, screened=None,
              thresh: float = 1e-13, omega=None):
    """Dense (nao, nao, nao, nao) ERI tensor (chemist's (ij|kl)).

    s8-canonical quartets + transpose symmetrization.
    `screened`: output of screened_pair_classes for Schwarz-pruned pair
    lists (quartet groups with max Q_ab*Q_cd < thresh are dropped wholesale).
    `omega`: long-range erf(omega*r12)/r12 kernel instead of 1/r12.

    Inside one scatter call every flat index occurs once (a shell-pair
    quartet owns its AO block), so the atomics a CUDA index_add uses cannot
    reorder a sum: the tensor is the same from run to run. Each of the three
    transposed adds makes a new tensor of the full size while its input is
    alive, so the symmetrisation peaks at twice nao^4 * 8 bytes."""
    nao = meta.nao
    dev = params["atompos"].device
    if screened is not None:
        pcs = [pc for (pc, q) in screened]
        qlist = [np.asarray(q) for (pc, q) in screened]
    else:
        pcs = tri_pair_classes(meta)
        qlist = None
    factors = []
    idxs = []
    diags = []
    for pc in pcs:
        if pc.npair == 0:
            factors.append(None)
            idxs.append(None)
            diags.append(None)
            continue
        inp = gather_pair_inputs(meta, params, pc)
        factors.append(hermite_factor_pair(inp))
        idxs.append(torch.as_tensor(
            pair_ao_indices(meta, pc).reshape(pc.npair, -1), device=dev))
        diags.append((pc.ia == pc.ib) if pc.ca == pc.cb
                     else np.zeros(pc.npair, dtype=bool))

    out = torch.zeros((nao * nao * nao * nao,), dtype=DTYPE, device=dev)
    n2 = nao * nao
    for gi in range(len(pcs)):
        for gj in range(gi, len(pcs)):
            if factors[gi] is None or factors[gj] is None:
                continue
            if qlist is not None:
                # wholesale quartet-group skip if max bound below threshold
                if float(qlist[gi].max()) * float(qlist[gj].max()) < thresh:
                    continue
            blk = coulomb_contract(factors[gi], factors[gj], block=block,
                                   omega=omega)
            # weights for symmetry dedup
            w1 = np.where(diags[gi], 0.5, 1.0)[:, None]
            w2 = np.where(diags[gj], 0.5, 1.0)[None, :]
            w = w1 * w2
            if gi == gj:
                npair = pcs[gi].npair
                tri = np.triu(np.ones((npair, npair)))
                w = w * tri * np.where(np.eye(npair, dtype=bool), 0.5, 1.0)
            blk = blk * torch.as_tensor(w, dtype=blk.dtype,
                                        device=dev)[:, None, :, None]
            flat = (idxs[gi][:, :, None, None] * n2
                    + idxs[gj][None, None, :, :]).reshape(-1)
            if blk.requires_grad:
                out = out.index_add(0, flat, blk.reshape(-1))
            else:
                out.index_add_(0, flat, blk.reshape(-1))
    g = out.reshape(nao, nao, nao, nao)
    del out           # so that each transposed add frees its input
    g = g + g.permute(1, 0, 2, 3)
    g = g + g.permute(0, 1, 3, 2)
    g = g + g.permute(2, 3, 0, 1)
    return g


def _aux_factors(meta: BasisMeta, params):
    """Hermite factors of every shell class of a basis, treated as single
    shells (the aux side of DF). Returns a list of (factor, ao_starts, l)."""
    out = []
    dev = params["atompos"].device
    for ci, cls in enumerate(meta.classes):
        coeffs = normalized_coeffs(cls.l, params["alphas"][ci],
                                   params["coeffs"][ci], params["mask"][ci])
        pos = params["atompos"][torch.as_tensor(np.asarray(cls.atom_ids),
                                                device=dev)]
        fac = hermite_factor_single(cls.l, pos, params["alphas"][ci], coeffs)
        out.append((fac, np.asarray(cls.ao_starts), cls.l))
    return out


def _packed_perm(facs, naux):
    """Host permutation: packed (class-concatenated) column -> true AO
    column, returned as its inverse for direct indexing."""
    cols = [
        (np.asarray(st)[:, None] + np.arange(nsph(l))[None, :]).ravel()
        for (_, st, l) in facs]
    perm = np.concatenate(cols)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(naux)
    return inv


def coul2c(meta_aux: BasisMeta, params_aux, block=None, omega=None):
    """(aux_i | g | aux_j) -> (naux, naux), g = 1/r12 or erf(omega r)/r12.

    Assembled by class-block concatenation and one permutation, as in the
    JAX package."""
    naux = meta_aux.nao
    facs = _aux_factors(meta_aux, params_aux)
    inv = torch.as_tensor(_packed_perm(facs, naux),
                          device=params_aux["atompos"].device)
    rows = []
    for (fa, _, _) in facs:
        row = []
        for (fb, _, _) in facs:
            blk = coulomb_contract(fa, fb, block=block,
                                   omega=omega)      # (na, sa, nb, sb)
            na, sa = blk.shape[0], blk.shape[1]
            row.append(blk.reshape(na * sa, -1))
        rows.append(torch.cat(row, dim=1))
    packed = torch.cat(rows, dim=0)
    return packed[inv][:, inv]


def coul3c(meta: BasisMeta, params, meta_aux: BasisMeta, params_aux,
           block=None, omega=None):
    """(ab | g | aux) -> (nao, nao, naux), g = 1/r12 or erf(omega r)/r12.

    Canonical shell pairs (a <= b) only, diagonal pairs at half weight, then
    g + g.transpose(0, 1), as in the JAX package. Each pair class scatters
    its rows once; no row repeats inside one scatter, so the result is the
    same from run to run on the card. Under autograd coulomb_contract
    recomputes each block in the backward (checkpoint), as for eri_dense."""
    nao, naux = meta.nao, meta_aux.nao
    dev = params["atompos"].device
    facs_aux = _aux_factors(meta_aux, params_aux)
    inv = torch.as_tensor(_packed_perm(facs_aux, naux), device=dev)
    out = torch.zeros((nao * nao, naux), dtype=DTYPE, device=dev)
    for pc in tri_pair_classes(meta):
        if pc.npair == 0:
            continue
        inp = gather_pair_inputs(meta, params, pc)
        fab = hermite_factor_pair(inp)
        idx_ab = torch.as_tensor(pair_ao_indices(meta, pc).reshape(-1),
                                 device=dev)
        diag = ((pc.ia == pc.ib) if pc.ca == pc.cb
                else np.zeros(pc.npair, dtype=bool))
        w = torch.as_tensor(np.where(diag, 0.5, 1.0), dtype=DTYPE,
                            device=dev)
        # all aux classes packed along the last axis, then one permutation
        blocks = [coulomb_contract(fab, fc, block=block, omega=omega).reshape(
            pc.npair, -1, len(st) * nsph(lc))
            for (fc, st, lc) in facs_aux]
        big = torch.cat(blocks, dim=-1)[:, :, inv]
        del blocks
        big = (big * w[:, None, None]).reshape(-1, naux)
        if big.requires_grad:
            out = out.index_add(0, idx_ab, big)
        else:
            out.index_add_(0, idx_ab, big)
    g = out.reshape(nao, nao, naux)
    del out
    return g + g.transpose(0, 1)
