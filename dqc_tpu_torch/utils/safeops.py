"""NaN-safe / differentiable helper ops (counterpart of
dqc_tpu/utils/safeops.py): occnumber, safepow, safenorm, safe_cdist."""
from __future__ import annotations

import math

import torch

EPS = 1e-15


def occnumber(a, n: int, dtype=torch.float64, device="cpu"):
    """Occupation vector of length n summing to `a` (possibly fractional):
    floor(a) ones then the fractional remainder. The integer split uses the
    concrete value of `a`; a tensor `a` keeps its gradient through the
    fractional element."""
    aval = float(a)
    nint = int(math.floor(aval + 1e-12))
    if nint > n:
        raise ValueError(f"Cannot fit {a} electrons in {n} orbitals")
    a_t = torch.as_tensor(a, dtype=dtype, device=device)
    base = torch.cat([torch.ones(nint, dtype=dtype, device=device),
                      torch.zeros(n - nint, dtype=dtype, device=device)])
    if nint < n:
        onehot = torch.zeros(n, dtype=dtype, device=device)
        onehot[nint] = 1.0
        return base + onehot * (a_t - nint)
    # a exactly fills all n orbitals: distribute any difference evenly
    return base + (a_t - nint) / max(n, 1)


def safepow(x, p, eps: float = EPS):
    """x**p safe for x ~ 0 with fractional p (gradient-stable)."""
    return torch.clamp(x, min=eps) ** p


def safenorm(x, axis=-1, eps: float = EPS):
    """L2 norm with nonzero gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=axis) + eps * eps)


def safe_cdist(a, b, add_diag_eps: bool = False):
    """Pairwise distances |a_i - b_j| with NaN-safe gradient; optionally
    regularize the diagonal (for self-distance exclusion)."""
    d = a[..., :, None, :] - b[..., None, :, :]
    d2 = torch.sum(d * d, dim=-1)
    if add_diag_eps:
        n = d2.shape[-1]
        d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device)
    return torch.sqrt(torch.clamp(d2, min=EPS * EPS))
