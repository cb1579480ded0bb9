"""McMurchie–Davidson recursions, batched over shell pairs.

Counterpart of dqc_tpu/ops/mcd.py. Angular momenta are Python ints (static
per shell class), so all recursions unroll into straight-line tensor ops
over batched pair tensors — there is no data-dependent control flow, and
torch.autograd differentiates integrals directly.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .boys import boys_list


def e_coeffs(la: int, lb: int, PA, PB, inv2p) -> Dict[Tuple[int, int, int], object]:
    """Hermite expansion coefficients E_t^{ij} for one cartesian dimension,
    all three dims batched in the trailing axis.

    PA, PB: (..., 3) = P - A, P - B;  inv2p: (...,) = 1/(2p).
    Returns dict {(t, i, j): (..., 3)} for 0<=i<=la, 0<=j<=lb, 0<=t<=i+j.
    E^{00}_0 = 1 (the gaussian prefactor exp(-mu |AB|^2) is applied by the
    caller as a scalar)."""
    inv2p = inv2p[..., None]  # broadcast over dim axis
    E: Dict[Tuple[int, int, int], object] = {}
    E[(0, 0, 0)] = torch.ones_like(PA)

    def get(t, i, j):
        if t < 0 or t > i + j or i < 0 or j < 0:
            return None
        return E[(t, i, j)]

    def build(t, i, j, X):
        # raise i (X=PA) or j (X=PB): E_t^{i+1,j} etc.
        terms = []
        em1 = get(t - 1, i, j)
        if em1 is not None:
            terms.append(inv2p * em1)
        e0 = get(t, i, j)
        if e0 is not None:
            terms.append(X * e0)
        ep1 = get(t + 1, i, j)
        if ep1 is not None:
            terms.append((t + 1) * ep1)
        return sum(terms)

    for i in range(la):
        for t in range(0, i + 2):
            E[(t, i + 1, 0)] = build(t, i, 0, PA)
    for j in range(lb):
        for i in range(la + 1):
            for t in range(0, i + j + 2):
                E[(t, i, j + 1)] = build(t, i, j, PB)
    return E


def hermite_coulomb_R(L: int, p, PC, scale=None):
    """Hermite Coulomb integrals R_{tuv} = R^0_{tuv}(p, PC).

    p: (...,), PC: (..., 3) tensor or a tuple (X, Y, Z) of component
    tensors. Returns dict {(t,u,v): (...,)} for t+u+v <= L.
    R^n_{000} = (-2p)^n F_n(p |PC|^2); index raising:
      R^n_{t+1,u,v} = t R^{n+1}_{t-1,u,v} + X_PC R^{n+1}_{t,u,v}  (etc.)

    `scale` (optional, broadcastable to p) multiplies every R value; it is
    folded into the Boys base.
    """
    if isinstance(PC, (tuple, list)):
        X, Y, Z = PC
    else:
        X, Y, Z = PC[..., 0], PC[..., 1], PC[..., 2]
    T = p * (X * X + Y * Y + Z * Z)
    base = boys_list(T, L)                 # list of L+1 tensors, T's shape
    m2p = -2.0 * p
    pw = torch.ones_like(p) if scale is None else scale
    for n in range(L + 1):
        base[n] = base[n] * pw
        if n < L:
            pw = pw * m2p

    memo: Dict[Tuple[int, int, int, int], object] = {}

    def R(n, t, u, v):
        key = (n, t, u, v)
        if key in memo:
            return memo[key]
        if t == u == v == 0:
            res = base[n]
        elif t >= 1:
            res = X * R(n + 1, t - 1, u, v)
            if t >= 2:
                res = res + (t - 1) * R(n + 1, t - 2, u, v)
        elif u >= 1:
            res = Y * R(n + 1, t, u - 1, v)
            if u >= 2:
                res = res + (u - 1) * R(n + 1, t, u - 2, v)
        else:
            res = Z * R(n + 1, t, u, v - 1)
            if v >= 2:
                res = res + (v - 1) * R(n + 1, t, u, v - 2)
        memo[key] = res
        return res

    out = {}
    for t in range(L + 1):
        for u in range(L + 1 - t):
            for v in range(L + 1 - t - u):
                out[(t, u, v)] = R(0, t, u, v)
    # R refers to itself through its closure: emptying the cell breaks that
    # cycle, so memo's tensors go with this call and not when the cyclic
    # garbage collector next runs
    del R
    return out


def hermite_multipole(e_max: int, lab: int, PC, inv2p):
    """Hermite multipole integrals M_t^e = \\int Lambda_t(x) (x - C)^e dx for
    one dimension (batched over the trailing dim axis like e_coeffs).

    PC: (..., 3) = P - C; inv2p: (...,) = 1/(2p).
    Returns dict {(e, t): (..., 3)} for 0<=e<=e_max, 0<=t<=e.
    M_t^0 = delta_{t0} sqrt(pi/p); recursion (Helgaker 9.5.31):
      M_t^{e+1} = t M_{t-1}^e + X_PC M_t^e + 1/(2p) M_{t+1}^e

    Intermediates are built for ALL t <= e even when t > lab: the downward
    1/(2p) M_{t+1} coupling feeds the Gaussian-width contribution into the
    t<=lab entries (for an s-s pair, M_0^2 needs M_1^1).
    """
    inv2p = inv2p[..., None]
    sqrt_pi_over_p = torch.sqrt(math.pi * 2.0 * inv2p)
    M: Dict[Tuple[int, int], object] = {}
    M[(0, 0)] = sqrt_pi_over_p * torch.ones_like(PC)

    def get(e, t):
        return M.get((e, t), None)

    for e in range(e_max):
        for t in range(0, e + 2):
            terms = []
            m_dn = get(e, t - 1)
            if m_dn is not None and t >= 1:
                terms.append(t * m_dn)
            m_0 = get(e, t)
            if m_0 is not None:
                terms.append(PC * m_0)
            m_up = get(e, t + 1)
            if m_up is not None:
                terms.append(inv2p * m_up)
            M[(e + 1, t)] = sum(terms) if terms else torch.zeros_like(PC)
    return M


def hermite_list(L: int):
    """Canonical ordering of Hermite indices (t,u,v) with t+u+v <= L."""
    return [(t, u, v) for t in range(L + 1) for u in range(L + 1 - t)
            for v in range(L + 1 - t - u)]


def e_coeffs_stacked(la: int, lb: int, PA, PB, inv2p):
    """E_t^{ij} stacked to one dense tensor for gather-based assembly.

    Returns (..., 3, T, la+1, lb+1) with T = la+lb+1; entries with t > i+j
    are zero. (...) is the batch shape of inv2p; PA/PB are (..., 3)."""
    E = e_coeffs(la, lb, PA, PB, inv2p)
    T = la + lb + 1
    zero = torch.zeros_like(PA)  # (..., 3)
    mats = []
    for t in range(T):
        for i in range(la + 1):
            for j in range(lb + 1):
                mats.append(E.get((t, i, j), zero))
    out = torch.stack(mats, dim=-1)  # (..., 3, T*(la+1)*(lb+1))
    return out.reshape(out.shape[:-1] + (T, la + 1, lb + 1))


def hermite_R_stacked(L: int, p, PC, scale=None):
    """R_{tuv} stacked over hermite_list(L): returns (..., nh)."""
    R = hermite_coulomb_R(L, p, PC, scale=scale)
    return torch.stack([R[h] for h in hermite_list(L)], dim=-1)


def _cart_components(l: int):
    return [(i, j, l - i - j) for i in range(l, -1, -1)
            for j in range(l - i, -1, -1)]


def e3_pair(la: int, lb: int, Earr):
    """Cartesian-pair x Hermite table via one gather per dimension.

    Earr: (..., 3, T, la+1, lb+1) from e_coeffs_stacked.
    Returns (..., ncart_a*ncart_b, nh) where
      out[..., (ca,cb), h] = Ex[t, ax_a, ax_b] Ey[u, ...] Ez[v, ...]."""
    ca_list, cb_list = _cart_components(la), _cart_components(lb)
    hl = hermite_list(la + lb)
    T = la + lb + 1
    n_ab = (la + 1) * (lb + 1)
    N = T * n_ab
    idxs = []
    for d in range(3):
        m = np.zeros((len(ca_list) * len(cb_list), len(hl)), dtype=np.int64)
        for ci, pa in enumerate(ca_list):
            for cj, pb in enumerate(cb_list):
                for hi, h in enumerate(hl):
                    t = h[d]
                    m[ci * len(cb_list) + cj, hi] = (
                        t * n_ab + pa[d] * (lb + 1) + pb[d])
        idxs.append(torch.as_tensor(m, device=Earr.device))
    batch = Earr.shape[:-4]
    flat = Earr.reshape(batch + (3, N))
    out = (flat[..., 0, :][..., idxs[0]]
           * flat[..., 1, :][..., idxs[1]]
           * flat[..., 2, :][..., idxs[2]])
    return out


def gaussian_product(la, lb, A, B, aa, ab):
    """Gaussian product theorem quantities for batched primitive pairs.

    A, B: (np, 3); aa: (np, ka); ab: (np, kb).
    Returns dict with p, P, PA, PB, pref (K_AB = exp(-mu |AB|^2)), all with
    leading shape (np, ka, kb) (dim axis last where applicable)."""
    a_ = aa[:, :, None]                          # (np, ka, 1)
    b_ = ab[:, None, :]                          # (np, 1, kb)
    p = a_ + b_                                  # (np, ka, kb)
    AB = A - B                                   # (np, 3)
    mu = a_ * b_ / p
    pref = torch.exp(-mu * torch.sum(AB * AB, dim=-1)[:, None, None])
    P = (a_[..., None] * A[:, None, None, :] +
         b_[..., None] * B[:, None, None, :]) / p[..., None]   # (np,ka,kb,3)
    PA = P - A[:, None, None, :]
    PB = P - B[:, None, None, :]
    return {"p": p, "P": P, "PA": PA, "PB": PB, "pref": pref,
            "inv2p": 0.5 / p}
