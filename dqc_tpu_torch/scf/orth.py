"""Orbital orthogonalizer: S -> X with X^T S X = I (on the kept subspace).

Counterpart of dqc_tpu/scf/orth.py: symmetric orthogonalization with a
small-eigenvalue cutoff for overcomplete bases. Near-null directions are
*masked* (their X columns are zeroed) and the mask is reported; the SCF
engine pins the Fock matrix diagonal to +LARGE on masked columns so they are
never occupied. PyTorch would allow dropping the columns; masking keeps
`X` and `keep` comparable with the JAX package.

Derivative: X is determined by S only up to X -> X R (R orthogonal), and
nothing the SCF computes from it (the density matrix, the energy, the
orbitals and their energies) depends on that choice. With every direction
kept, X therefore takes the gauge-fixed rule dX = -1/2 X X^T dS X (it
keeps X^T S X = I; X^H for a complex S) instead of the derivative of S's
eigenvectors, which divides by the gaps between S's eigenvalues: S of a
symmetric molecule has degenerate levels split by rounding, and 1/gap
times rounding is noise of order one. The rule needs no eigenvalue and is exact to every order for
those quantities. With masked directions X keeps safe_eigh's rule.
"""
from __future__ import annotations

import torch

from .eigh import safe_eigh

LARGE = 1e7


class _FullRank(torch.autograd.Function):
    """X of a full-rank S with the gauge-fixed derivative (module
    docstring); the backward is written in X, so it differentiates again."""

    @staticmethod
    def forward(ctx, ovlp, x):
        x = x.clone()
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, xbar):
        (x,) = ctx.saved_tensors
        g = -0.5 * (x @ x.mH @ xbar @ x.mH)
        return 0.5 * (g + g.mH), None


def orthogonalizer(ovlp, threshold: float = 1e-9):
    """Returns (X, keep_mask). X: (nao, nao) with masked columns zeroed;
    a batch of Hermitian overlaps (the per-k S^k of a k-point cell) gives
    a batch, X^H S X = I on the kept subspace."""
    w, v = safe_eigh(ovlp)
    keep = w > threshold * w[..., -1:]
    one = torch.ones_like(w)
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, w, one)),
                           torch.zeros_like(w))
    X = v * inv_sqrt[..., None, :].to(v.dtype)
    if ovlp.requires_grad and bool(keep.all()):
        X = _FullRank.apply(ovlp, X.detach())
    return X, keep
