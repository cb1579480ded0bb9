"""Orbital orthogonalizer: S -> X with X^T S X = I (on the kept subspace).

Counterpart of dqc_tpu/scf/orth.py: symmetric orthogonalization with a
small-eigenvalue cutoff for overcomplete bases. Near-null directions are
*masked* (their X columns are zeroed) and the mask is reported; the SCF
engine pins the Fock matrix diagonal to +LARGE on masked columns so they are
never occupied. PyTorch would allow dropping the columns; masking keeps
`X` and `keep` comparable with the JAX package.
"""
from __future__ import annotations

import torch

from .eigh import safe_eigh

LARGE = 1e7


def orthogonalizer(ovlp, threshold: float = 1e-9):
    """Returns (X, keep_mask). X: (nao, nao) with masked columns zeroed."""
    w, v = safe_eigh(ovlp)
    keep = w > threshold * w[-1]
    one = torch.ones_like(w)
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, w, one)),
                           torch.zeros_like(w))
    X = v * inv_sqrt[None, :]
    return X, keep
