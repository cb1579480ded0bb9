"""Boys function F_m(T) = \\int_0^1 t^{2m} exp(-T t^2) dt on tensors.

Counterpart of dqc_tpu/ops/boys.py, with its derivative rule
dF_m/dT = -F_{m+1} (`_Boys`, a torch.autograd.Function whose backward calls
boys_list again through the same Function, so every order stays exact and
autograd never records the 90-step series).
  - two branches: nested power series at m = mmax + downward recursion for
    T <= 27, closed-form erf F_0 + upward recursion beyond.
  - both branches are computed for every element and joined with
    torch.where — no data-dependent control flow. The minimum/maximum clamps
    keep each branch's argument inside the range where it cannot overflow.
  - `boys_list` returns [F_0..F_mmax] as separate tensors.
In eager PyTorch the unrolled 90-step Horner chain is about 180 small
launches a call; it is kept as it is (right first), not tuned.

Series: F_m(T) = e^{-T} sum_k (2T)^k (2m-1)!!/(2m+2k+1)!! — all terms
positive (no cancellation); NTERMS=90 converges to f64 for T <= 27.
Downward F_{m-1} = (2T F_m + e^{-T})/(2m-1) is unconditionally stable;
upward F_{m+1} = ((2m+1) F_m - e^{-T})/(2T) is stable for T > m.
"""
from __future__ import annotations

import math

import torch

T_SWITCH = 27.0
NTERMS = 90


def _boys_values(T, mmax: int):
    """[F_0, ..., F_mmax] by the two branches, without a derivative rule."""
    # series branch (T <= T_SWITCH), nested/Horner form, unrolled
    t_s = torch.clamp(T, max=T_SWITCH)
    x = 2.0 * t_s
    exp_s = torch.exp(-t_s)
    s = torch.ones_like(t_s)
    for k in range(NTERMS, 0, -1):
        s = 1.0 + x * s * (1.0 / (2 * mmax + 2 * k + 1))
    f_small = [s * exp_s * (1.0 / (2 * mmax + 1))]   # F_mmax first
    for mm in range(mmax, 0, -1):
        f_small.append((x * f_small[-1] + exp_s) * (1.0 / (2 * mm - 1)))
    f_small = f_small[::-1]                          # [F_0..F_mmax]

    # asymptotic branch (T > T_SWITCH): erf closed form + upward recursion
    t_l = torch.clamp(T, min=T_SWITCH)
    sq = torch.sqrt(t_l)
    exp_l = torch.exp(-t_l)
    inv2T = 0.5 / t_l
    f_large = [0.5 * math.sqrt(math.pi) * torch.special.erf(sq) / sq]
    for mm in range(mmax):
        f_large.append(((2 * mm + 1) * f_large[-1] - exp_l) * inv2T)

    is_small = T < T_SWITCH
    return [torch.where(is_small, a, b) for a, b in zip(f_small, f_large)]


class _Boys(torch.autograd.Function):
    """F_0..F_mmax of T with dF_m/dT = -F_{m+1}."""

    @staticmethod
    def forward(ctx, T, mmax):
        ctx.mmax = mmax
        ctx.save_for_backward(T)
        return tuple(_boys_values(T, mmax))

    @staticmethod
    def backward(ctx, *fbar):
        (T,) = ctx.saved_tensors
        f = boys_list(T, ctx.mmax + 1)
        return -sum(g * f[m + 1] for m, g in enumerate(fbar)), None


def boys_list(T, mmax: int):
    """Boys functions as a list [F_0, ..., F_mmax], each of T's shape."""
    return list(_Boys.apply(T, mmax))


def boys(T, mmax: int):
    """Boys functions F_0..F_mmax. T: any shape; returns shape T.shape+(mmax+1,)."""
    return torch.stack(boys_list(T, mmax), dim=-1)
