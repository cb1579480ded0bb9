"""Exact J and K past the dense limit: the blocked route (the canonical
shell-pair quartet blocks cached in theta, contracted with the density on
every Fock build) and the streamed route (integral-direct SCF: each block is
rebuilt, contracted and dropped on every Fock build, nothing is stored).

Counterpart of dqc_tpu/scf/jk.py. With G0 the canonical quartet tensor
(each (ab|cd) once, the diagonal weights of ops/eri.eri_dense folded in)
and dm symmetric,
    J = 2 (A + B) + transposes,   A = G0 contracted over its ket pair,
                                   B = G0 contracted over its bra pair
    K = the 4 (bra index x ket index) pairings P_xy, + transposes,
all done block by block, one block per (bra pair group, ket pair group)
combo. A block is `coulomb_contract` of the two groups' Hermite factors
(the quartets of eri_dense without its scatter into nao^4).

The contractions are plain torch, as they are XLA einsums in the JAX
package. Every sum has a fixed order, so that two Fock builds from the same
dm give the same bits on the card: J's scatter adds each AO pair of a group
once per call (no index repeats), and K's, where all pairs that share a
shell share its rows, is a product with a 0/1 fold matrix per side
(`_sides`) instead of an index_add, whose atomics would add repeated
indices in any order. The pairings are batched matrix products over the
(bra pair, ket pair) batch: (a c) x (b d) serves P_ac and, transposed,
P_bd; (a d) x (b c) serves P_ad and P_bc, so a block is laid out anew twice
per build.

A batch of geometries (parallel/batch.py) stacks each member's blocks, or
its factors, on a leading member axis (each member's own, built by its own
theta from the calc's one screened jk_meta, so every member's blocks have
the same shapes); jk_from_blocks and jk_matrices then take dm (B, [2,]
nao, nao) and contract member by member, each member with the bits of its
unbatched call.

The JAX package's mesh sharding of jk_from_blocks spreads the blocks over
TPU chips and has no counterpart on one card (PERF.md §6); nor have
expand_k_tensor, expand_k_tensor_host and host_jk_builder, which reach
eri_k from the blocks and split the program for the TPU compiler: the
dense route builds eri_k directly.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.eri import HermiteFactor, coulomb_contract, hermite_factor_pair
from ..ops.shellstruct import (BasisMeta, gather_pair_inputs, nsph,
                               tri_pair_classes)
from ..utils.datastruct import stack_members


def build_jk_meta(meta: BasisMeta, screened=None):
    """Host-side static structure of both routes: per shell-pair group its
    pair list, spherical sizes, AO row/column starts and the 0.5 weight of
    diagonal pairs. `screened` is ops/eri.screened_pair_classes' output;
    groups that screening left empty are dropped (they add nothing)."""
    if screened is not None:
        pcs = [pc for (pc, _) in screened]
    else:
        pcs = tri_pair_classes(meta)
    info = []
    for pc in pcs:
        if pc.npair == 0:
            continue
        A = meta.classes[pc.ca]
        B = meta.classes[pc.cb]
        diag = ((pc.ia == pc.ib) if pc.ca == pc.cb
                else np.zeros(pc.npair, dtype=bool))
        info.append({
            "pc": pc, "sa": nsph(A.l), "sb": nsph(B.l), "L": A.l + B.l,
            "nao": meta.nao,
            "row0": np.asarray(A.ao_starts, dtype=np.int64)[pc.ia],
            "col0": np.asarray(B.ao_starts, dtype=np.int64)[pc.ib],
            "w": np.where(diag, 0.5, 1.0),
        })
    return info


def build_jk_factors(meta: BasisMeta, params, jk_meta) -> List[HermiteFactor]:
    """Hermite factor of every pair group (inside the theta build; reused by
    every Fock build of the streamed route)."""
    return [hermite_factor_pair(gather_pair_inputs(meta, params, inf["pc"]))
            for inf in jk_meta]


def factors_to_theta(facs) -> dict:
    """The factors as a nested dict of tensors (theta's form, whose leaves
    the implicit derivative sees)."""
    return {str(i): {"H": f.H, "p": f.p, "P": f.P} for i, f in enumerate(facs)}


def theta_factors(theta, jk_meta) -> List[HermiteFactor]:
    """The Hermite factors of theta['jk_facs'], in group order."""
    d = theta["jk_facs"]
    return [HermiteFactor(H=d[str(i)]["H"], p=d[str(i)]["p"],
                          P=d[str(i)]["P"], L=inf["L"])
            for i, inf in enumerate(jk_meta)]


def jk_combos(jk_meta):
    """Canonical (gi, gj) combo order shared by every consumer."""
    ng = len(jk_meta)
    return [(gi, gj) for gi in range(ng) for gj in range(gi, ng)]


def jk_blocks_nbytes(jk_meta) -> int:
    """f64 bytes of the whole weighted canonical block set: the host-side
    sizing input of the route choice (scf/qccalc._route)."""
    tot = 0
    for (gi, gj) in jk_combos(jk_meta):
        ip, iq = jk_meta[gi], jk_meta[gj]
        tot += (len(ip["row0"]) * ip["sa"] * ip["sb"]
                * len(iq["row0"]) * iq["sa"] * iq["sb"] * 8)
    return tot


def _combo_block(ip, iq, same_group: bool, fac_p, fac_q, block=None):
    """Weighted canonical quartet block of one combo, (np1, sa, sb, np2, sc,
    sd): 0.5 on diagonal pairs, and for gi == gj the upper triangle with 0.5
    on its diagonal (the weights of eri_dense). Density-independent: the
    payload the blocked route caches in theta."""
    sa, sb, sc, sd = ip["sa"], ip["sb"], iq["sa"], iq["sb"]
    np1, np2 = len(ip["row0"]), len(iq["row0"])
    # (np1, sa sb, np2, sc sd)
    blk = coulomb_contract(fac_p, fac_q, block=block)
    w = ip["w"][:, None] * iq["w"][None, :]
    if same_group:
        w = w * np.triu(np.ones((np1, np2))) * np.where(
            np.eye(np1, dtype=bool), 0.5, 1.0)
    blk = blk * torch.as_tensor(w, dtype=blk.dtype,
                                device=blk.device)[:, None, :, None]
    return blk.reshape(np1, sa, sb, np2, sc, sd)


def build_jk_block(meta: BasisMeta, params, jk_meta, ci: int, block=None):
    """The weighted block of combo `ci` from the basis params."""
    (gi, gj) = jk_combos(jk_meta)[ci]
    fac_p = hermite_factor_pair(gather_pair_inputs(meta, params,
                                                   jk_meta[gi]["pc"]))
    fac_q = fac_p if gj == gi else hermite_factor_pair(
        gather_pair_inputs(meta, params, jk_meta[gj]["pc"]))
    return _combo_block(jk_meta[gi], jk_meta[gj], gi == gj, fac_p, fac_q,
                        block)


def build_jk_blocks(meta: BasisMeta, params, jk_meta):
    """The weighted blocks of every combo, in jk_combos order, from one set
    of Hermite factors (the blocked route's theta entries 'jkb{i}')."""
    facs = build_jk_factors(meta, params, jk_meta)
    return [_combo_block(jk_meta[gi], jk_meta[gj], gi == gj, facs[gi],
                         facs[gj])
            for (gi, gj) in jk_combos(jk_meta)]


def theta_blocks(theta, jk_meta):
    """Ordered block list from the per-combo theta entries 'jkb{i}'."""
    return [theta[f"jkb{i}"] for i in range(len(jk_combos(jk_meta)))]


def _sides(inf, dev):
    """Per group and device (cached on the group's entry): the AO rows of
    its bra side (ra) and ket side (rb), flattened (pair-major), the flat
    (nao*nao) indices of its AO blocks, and the 0/1 folds F_a, F_b (nao,
    np*s) with F[ra[m], m] = 1."""
    cache = inf.setdefault("_dev", {})
    key = str(dev)
    if key not in cache:
        nao = inf["nao"]
        ra = (inf["row0"][:, None] + np.arange(inf["sa"])).ravel()
        rb = (inf["col0"][:, None] + np.arange(inf["sb"])).ravel()
        flat = ((inf["row0"][:, None, None] + np.arange(inf["sa"])[:, None])
                * nao + inf["col0"][:, None, None]
                + np.arange(inf["sb"])[None, :]).ravel()

        def fold(r):
            f = np.zeros((nao, len(r)))
            f[r, np.arange(len(r))] = 1.0
            return torch.as_tensor(f, device=dev)
        cache[key] = {"ra": torch.as_tensor(ra, device=dev),
                      "rb": torch.as_tensor(rb, device=dev),
                      "flat": torch.as_tensor(flat, device=dev),
                      "Fa": fold(ra), "Fb": fold(rb)}
    return cache[key]


def _pairing(blk, perm, dl, dr):
    """Two K pairings from one layout of the block. X = blk laid out by
    `perm` as (np1 np2, x, y) matrices, x and y two spherical index pairs
    (one of the bra, one of the ket each); returns X D_l (np1 np2, x, ns)
    and X^T D_r (np1 np2, y, ns), with dl (np1, np2, y.., ns) and dr (np1,
    np2, x.., ns) the gathered densities."""
    np1, np2 = blk.shape[0], blk.shape[3]
    x = blk.permute(*perm)
    sx = x.shape[2] * x.shape[3]
    sy = x.shape[4] * x.shape[5]
    ns = dl.shape[-1]
    x = x.reshape(np1 * np2, sx, sy)
    left = torch.bmm(x, dl.reshape(np1 * np2, sy, ns))
    right = torch.bmm(x.transpose(1, 2), dr.reshape(np1 * np2, sx, ns))
    return left, right


def _gather(dmk, r1, s1, r2, s2, np1, np2):
    """dm[:, r1, r2] as (np1, np2, s1, s2, ns)."""
    ns = dmk.shape[0]
    g = dmk.index_select(1, r1).index_select(2, r2)
    return g.reshape(ns, np1, s1, np2, s2).permute(1, 3, 2, 4, 0)


def _combo_contract(nao: int, ip, iq, blk, dmt, dmk, want_j: bool,
                    want_k: bool):
    """Density contractions of one combo's weighted block (np1, sa, sb, np2,
    sc, sd): (J_add (nao*nao,) or None, K_add (ns, nao, nao) or None), the
    raw canonical-quartet contractions before _jk_symmetrize. dmt: the total
    density (nao, nao); dmk: (ns, nao, nao), one per spin."""
    dev = blk.device
    sa, sb, sc, sd = ip["sa"], ip["sb"], iq["sa"], iq["sb"]
    np1, np2 = blk.shape[0], blk.shape[3]
    P, Q = _sides(ip, dev), _sides(iq, dev)
    Jadd = Kadd = None
    if want_j:
        # the block as a (pab) x (qcd) matrix: A = G0 dq, B = G0^T dp
        m = blk.reshape(np1 * sa * sb, np2 * sc * sd)
        dflat = dmt.reshape(-1)
        a = m @ dflat.index_select(0, Q["flat"])
        b = m.T @ dflat.index_select(0, P["flat"])
        Jadd = torch.zeros(nao * nao, dtype=blk.dtype, device=dev)
        Jadd = Jadd.index_add(0, P["flat"], a).index_add(0, Q["flat"], b)
    if want_k:
        ns = dmk.shape[0]
        d_bd = _gather(dmk, P["rb"], sb, Q["rb"], sd, np1, np2)
        d_ac = _gather(dmk, P["ra"], sa, Q["ra"], sc, np1, np2)
        d_bc = _gather(dmk, P["rb"], sb, Q["ra"], sc, np1, np2)
        d_ad = _gather(dmk, P["ra"], sa, Q["rb"], sd, np1, np2)
        # (p,q,a,c,b,d): P_ac = X D_bd, P_bd = X^T D_ac
        p_ac, p_bd = _pairing(blk, (0, 3, 1, 4, 2, 5), d_bd, d_ac)
        # (p,q,a,d,b,c): P_ad = X D_bc, P_bc = X^T D_ad
        p_ad, p_bc = _pairing(blk, (0, 3, 1, 5, 2, 4), d_bc, d_ad)
        Kadd = torch.zeros((ns, nao, nao), dtype=blk.dtype, device=dev)
        for pr, s1, s2, F1, F2 in ((p_ac, sa, sc, P["Fa"], Q["Fa"]),
                                   (p_bd, sb, sd, P["Fb"], Q["Fb"]),
                                   (p_ad, sa, sd, P["Fa"], Q["Fb"]),
                                   (p_bc, sb, sc, P["Fb"], Q["Fa"])):
            # (p, q, s1, s2, ns) -> (ns, np1 s1, np2 s2), then fold both
            # sides onto the AOs by two GEMMs
            pr = pr.reshape(np1, np2, s1, s2, ns).permute(4, 0, 2, 1, 3)
            pr = pr.reshape(ns, np1 * s1, np2 * s2)
            Kadd = Kadd + F1 @ pr @ F2.T
    return Jadd, Kadd


def _jk_symmetrize(Jflat, K, nao, pol, want_j, want_k):
    """J: the 8 images give 2 (A + A^T + B + B^T) for a symmetric dm; K:
    the 4 pairings and their transposes cover all 8."""
    J = None
    if want_j:
        J = Jflat.reshape(nao, nao)
        J = 2.0 * (J + J.T)
    if want_k:
        K = K + K.transpose(-1, -2)
        if not pol:
            K = K[0]
    return J, (K if want_k else None)


def _split_dm(dm):
    pol = dm.ndim == 3
    return pol, (dm.sum(dim=0) if pol else dm), (dm if pol else dm[None])


def jk_from_blocks(meta: BasisMeta, jk_meta, blocks, dm, want_j: bool = True,
                   want_k: bool = True):
    """J and/or K from the cached blocks (theta 'jkb{i}'). dm: (nao, nao) or
    (2, nao, nao) symmetric; J from the total density, K per spin, one pass
    over the blocks for both spins. A batch: blocks (B, np1, sa, sb, np2,
    sc, sd) with dm (B, [2,] nao, nao), member by member."""
    if blocks[0].ndim == 7:
        return stack_members([
            jk_from_blocks(meta, jk_meta, [b[m] for b in blocks], dm[m],
                           want_j, want_k) for m in range(dm.shape[0])])
    nao = meta.nao
    pol, dmt, dmk = _split_dm(dm)
    Jflat = torch.zeros(nao * nao, dtype=dm.dtype, device=dm.device)
    K = torch.zeros((dmk.shape[0], nao, nao), dtype=dm.dtype,
                    device=dm.device)
    for ci, (gi, gj) in enumerate(jk_combos(jk_meta)):
        Jadd, Kadd = _combo_contract(nao, jk_meta[gi], jk_meta[gj],
                                     blocks[ci], dmt, dmk, want_j, want_k)
        if Jadd is not None:
            Jflat = Jflat + Jadd
        if Kadd is not None:
            K = K + Kadd
    return _jk_symmetrize(Jflat, K, nao, pol, want_j, want_k)


def _combo_jk(nao: int, ip, iq, same_group: bool, fac_p, fac_q, dmt, dmk,
              want_j: bool, want_k: bool, block=None):
    """J/K contributions of one combo, streamed: its block is built and
    contracted, never stored."""
    blk = _combo_block(ip, iq, same_group, fac_p, fac_q, block)
    return _combo_contract(nao, ip, iq, blk, dmt, dmk, want_j, want_k)


def jk_matrices(meta: BasisMeta, jk_meta, facs: List[HermiteFactor], dm,
                want_j: bool = True, want_k: bool = True, block=None):
    """Streamed J and/or K for a (possibly spin-stacked) symmetric dm: each
    combo's block is built from the factors, contracted and dropped before
    the next. A batch: factors with a leading member axis (H (B, npair,
    nprim, nsph, nh)) and dm (B, [2,] nao, nao), member by member."""
    if facs[0].H.ndim == 5:
        return stack_members([
            jk_matrices(meta, jk_meta,
                        [HermiteFactor(H=f.H[m], p=f.p[m], P=f.P[m], L=f.L)
                         for f in facs], dm[m], want_j, want_k, block)
            for m in range(dm.shape[0])])
    nao = meta.nao
    pol, dmt, dmk = _split_dm(dm)
    Jflat = torch.zeros(nao * nao, dtype=dm.dtype, device=dm.device)
    K = torch.zeros((dmk.shape[0], nao, nao), dtype=dm.dtype,
                    device=dm.device)
    for (gi, gj) in jk_combos(jk_meta):
        Jadd, Kadd = _combo_jk(nao, jk_meta[gi], jk_meta[gj], gi == gj,
                               facs[gi], facs[gj], dmt, dmk, want_j, want_k,
                               block)
        if Jadd is not None:
            Jflat = Jflat + Jadd
        if Kadd is not None:
            K = K + Kadd
    return _jk_symmetrize(Jflat, K, nao, pol, want_j, want_k)
