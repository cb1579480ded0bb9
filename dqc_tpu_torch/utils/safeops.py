"""NaN-safe / differentiable helper ops (counterpart of
dqc_tpu/utils/safeops.py): occnumber, fmax, fmin, fclip, safepow, safenorm, safe_cdist,
and the density floors of the XC functionals."""
from __future__ import annotations

import math

import torch

EPS = 1e-15
# floors of the density and of |grad rho|^2 in the XC functionals (float64;
# the JAX package raises them for float32, which the port does not use)
RHO_EPS = 1e-28
SIG_EPS = 1e-40


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


def fmax(x, c: float):
    """max(x, c) with the gradient rule of jnp.maximum: at a tie the
    gradient is shared half and half (torch.clamp would pass all of it)."""
    return torch.maximum(x, x.new_tensor(c))


def fmin(x, c: float):
    """min(x, c) with the gradient rule of jnp.minimum (shared at a tie)."""
    return torch.minimum(x, x.new_tensor(c))


def fclip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi): max then min, each with the shared-tie rule
    (torch.clamp would pass the whole gradient at either bound)."""
    return fmin(fmax(x, lo), hi)


def safepow(x, p, eps: float = EPS):
    """x**p safe for x ~ 0 with fractional p (gradient-stable)."""
    return fmax(x, eps) ** p


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
