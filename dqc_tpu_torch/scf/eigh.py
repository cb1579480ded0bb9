"""Symmetric eigendecomposition (counterpart of dqc_tpu/scf/eigh.py).

Forward only: the degenerate-safe Lorentzian derivative rule of the JAX
package comes when implicit differentiation is ported. The
eigenvector polish of the JAX package has no counterpart: it repairs
f32-grade eigenvectors of an f64 solve on the TPU, while
torch.linalg.eigh in float64 (LAPACK on the CPU, cuSOLVER on the card) is
full precision.
"""
from __future__ import annotations

import torch


def safe_eigh(a):
    """(eigenvalues ascending, eigenvectors in columns) of a symmetric
    matrix or a batch of them."""
    w, v = torch.linalg.eigh(a)
    return w, v
