"""AO evaluation on grid points: values, gradients, laplacians
(counterpart of dqc_tpu/ops/aoeval.py).

A dense polynomial x exponential contraction over the class-batched shells
of ops/shellstruct.py, in plain torch, so gradients in positions, exponents
and coefficients come from autograd. The AO order is the order of the
integral matrices. eval_ao_pbc is the Gamma-point lattice sum of eval_ao
over translations, eval_ao_pbc_k the Bloch sums at k-points in the real
embedding [Re | Im] that the grid kernels read.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.config import block_bytes
from .mcd import _cart_components as cart_components
from .shellstruct import BasisMeta, normalized_coeffs, nsph, sph_transform


def _index(x, idx):
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=x.device)


def eval_ao(meta: BasisMeta, params, coords, deriv: int = 0):
    """coords: (ng, 3). Returns a dict with
      'ao': (ng, nao)
      'ao_grad': (ng, 3, nao)  if deriv >= 1
      'ao_lapl': (ng, nao)     if deriv >= 2
    """
    ng = coords.shape[0]
    nao = meta.nao
    pos = params["atompos"]
    blocks = {"ao": [], "ao_grad": [], "ao_lapl": []}
    col_idx = []
    for ci, cls in enumerate(meta.classes):
        l = cls.l
        A = pos[_index(pos, cls.atom_ids)]                   # (ns,3)
        alphas = params["alphas"][ci]                        # (ns,k)
        coeffs = normalized_coeffs(l, alphas, params["coeffs"][ci],
                                   params["mask"][ci])
        diff = coords[:, None, :] - A[None, :, :]            # (ng,ns,3)
        r2 = torch.sum(diff * diff, dim=-1)                  # (ng,ns)
        ex = torch.exp(-alphas[None] * r2[..., None])        # (ng,ns,k)
        s0 = torch.einsum("gsk,sk->gs", ex, coeffs)
        if deriv >= 1:
            s1 = torch.einsum("gsk,sk->gs", ex, coeffs * alphas)
        if deriv >= 2:
            s2 = torch.einsum("gsk,sk->gs", ex, coeffs * alphas * alphas)
        # power table P[..., d, m] = diff_d^m for m = 0..l
        pows = [torch.ones_like(diff)]
        for _ in range(l):
            pows.append(pows[-1] * diff)
        P = torch.stack(pows, dim=-1)                        # (ng,ns,3,l+1)
        carts = np.asarray(cart_components(l), dtype=np.int64)

        def pw(d, powers):
            return P[..., d, :][..., _index(P, powers)]

        poly = pw(0, carts[:, 0]) * pw(1, carts[:, 1]) * pw(2, carts[:, 2])
        Csph = torch.as_tensor(sph_transform(l), dtype=coords.dtype,
                               device=coords.device)
        blocks["ao"].append(torch.einsum("gsc,mc->gsm", poly * s0[..., None],
                                         Csph))
        if deriv >= 1:
            dpolys = []
            for d in range(3):
                p_d = torch.as_tensor(carts[:, d], dtype=coords.dtype,
                                      device=coords.device)
                dm1 = np.maximum(carts[:, d] - 1, 0)
                dpolys.append(p_d * pw((d + 1) % 3, carts[:, (d + 1) % 3])
                              * pw((d + 2) % 3, carts[:, (d + 2) % 3])
                              * pw(d, dm1))
            dpoly = torch.stack(dpolys, dim=-2)              # (ng,ns,3,nc)
            grad_c = (dpoly * s0[..., None, None]
                      - 2.0 * diff[..., None] * poly[..., None, :]
                      * s1[..., None, None])
            blocks["ao_grad"].append(torch.einsum("gsdc,mc->gdsm", grad_c,
                                                  Csph))
        if deriv >= 2:
            lap_p = 0.0
            graddot = 0.0
            for d in range(3):
                p_d = torch.as_tensor(carts[:, d], dtype=coords.dtype,
                                      device=coords.device)
                dm2 = np.maximum(carts[:, d] - 2, 0)
                lap_p = lap_p + p_d * (p_d - 1) * (
                    pw((d + 1) % 3, carts[:, (d + 1) % 3])
                    * pw((d + 2) % 3, carts[:, (d + 2) % 3]) * pw(d, dm2))
                graddot = graddot + diff[..., d, None] * dpolys[d]
            lapl_c = (lap_p * s0[..., None]
                      - 4.0 * graddot * s1[..., None]
                      + poly * (-6.0 * s1 + 4.0 * r2 * s2)[..., None])
            blocks["ao_lapl"].append(torch.einsum("gsc,mc->gsm", lapl_c,
                                                  Csph))
        starts = np.asarray(cls.ao_starts)
        col_idx.append((starts[:, None] + np.arange(nsph(l))[None, :]).ravel())

    cols = np.concatenate(col_idx)
    inv = np.empty_like(cols)
    inv[cols] = np.arange(nao)
    inv = _index(coords, inv)
    out = {"ao": torch.cat([b.reshape(ng, -1) for b in blocks["ao"]],
                           dim=-1)[:, inv]}
    if deriv >= 1:
        out["ao_grad"] = torch.cat(
            [b.reshape(ng, 3, -1) for b in blocks["ao_grad"]], dim=-1)[:, :, inv]
    if deriv >= 2:
        out["ao_lapl"] = torch.cat(
            [b.reshape(ng, -1) for b in blocks["ao_lapl"]], dim=-1)[:, inv]
    return out


# doubles of eval_ao's temporaries per point and AO (a bound from its
# polynomial, exponential and derivative tables at l <= 2)
_EVAL_DOUBLES_PER_POINT_AO = 48


def eval_ao_pbc(meta: BasisMeta, params, coords, ls, deriv: int = 0):
    """Lattice-summed (Gamma-point) AO tables: phi~_i(r) = sum_T phi_i(r -
    T) over the host-enumerated translations ls (nL, 3); the layout of
    eval_ao. The translations are taken as many at a time as utils/config's
    PBC_BLOCK_BYTES allows for these points and summed in their order."""
    ls = np.asarray(ls, dtype=np.float64)
    nL, ng = len(ls), coords.shape[0]
    per_shift = 8 * _EVAL_DOUBLES_PER_POINT_AO * ng * meta.nao
    shift_block = max(1, block_bytes(coords.device) // per_shift)
    acc = None
    for s0 in range(0, nL, shift_block):
        Tc = torch.as_tensor(ls[s0:s0 + shift_block], dtype=coords.dtype,
                             device=coords.device)
        nb = Tc.shape[0]
        tabs = eval_ao(meta, params, (coords[None] - Tc[:, None]).reshape(
            nb * ng, 3), deriv=deriv)
        red = {k: v.reshape((nb, ng) + v.shape[1:]).sum(dim=0)
               for k, v in tabs.items()}
        acc = red if acc is None else {k: acc[k] + red[k] for k in acc}
    return acc


def eval_ao_pbc_k(meta: BasisMeta, params, coords, ls, kpts, deriv: int = 0):
    """Bloch AO tables phi^k_i(r) = sum_T e^{ik.T} phi_i(r - T) at the
    k-points kpts (host numpy, (nk, 3)), each k's table stored as one real
    table [Re phi^k | Im phi^k] of width 2 nao:
      'ao': (nk, ng, 2 nao); 'ao_grad': (nk, 3, ng, 2 nao) if deriv >= 1;
      'ao_lapl': (nk, ng, 2 nao) if deriv >= 2.
    The translations are blocked by bytes as in eval_ao_pbc and summed in
    their order."""
    ls = np.asarray(ls, dtype=np.float64)
    kpts = np.asarray(kpts, dtype=np.float64).reshape(-1, 3)
    nL, ng = len(ls), coords.shape[0]
    per_shift = 8 * _EVAL_DOUBLES_PER_POINT_AO * ng * meta.nao
    shift_block = max(1, block_bytes(coords.device) // per_shift)
    acc = None
    for s0 in range(0, nL, shift_block):
        T_np = ls[s0:s0 + shift_block]
        Tc = torch.as_tensor(T_np, dtype=coords.dtype, device=coords.device)
        nb = Tc.shape[0]
        tabs = eval_ao(meta, params, (coords[None] - Tc[:, None]).reshape(
            nb * ng, 3), deriv=deriv)
        kdot = kpts @ T_np.T                                  # (nk, nb)
        ph = torch.as_tensor(np.concatenate([np.cos(kdot), np.sin(kdot)]),
                             dtype=coords.dtype, device=coords.device)
        red = {}
        for key, v in tabs.items():
            v = v.reshape((nb, -1))
            red[key] = (ph @ v).reshape((2 * len(kpts), ng) + tabs[key]
                                        .shape[1:])
        acc = red if acc is None else {k: acc[k] + red[k] for k in acc}
    nk, out = len(kpts), {}
    for key, v in acc.items():
        re, im = v[:nk], v[nk:]
        if key == "ao_grad":                       # (nk, ng, 3, nao)
            re, im = re.permute(0, 2, 1, 3), im.permute(0, 2, 1, 3)
        out[key] = torch.cat([re, im], dim=-1).contiguous()
    return out
