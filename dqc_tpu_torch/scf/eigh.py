"""Degenerate-safe symmetric eigendecomposition (counterpart of
dqc_tpu/scf/eigh.py).

torch.linalg.eigh's own backward divides by eigenvalue gaps, which are zero
for degenerate orbitals (atomic p shells, benzene's pi system). The JAX
package broadens the gap instead: with d_ab = w_b - w_a,
F_ab = d_ab / (d_ab^2 + eps^2) and F_aa = 0, its JVP is
  dw = diag(V^T sym(dA) V),  dV = V (F o (V^T sym(dA) V)).
`safe_eigh` is a torch.autograd.Function with that rule transposed:
  Abar = sym(V (diag(wbar) + F o (V^T Vbar)) V^T),
written with differentiable ops on the outputs, so double backward works.
A gap below 1024 eps max|w| counts as an exact degeneracy (F = 0 there,
as the rule gives for d = 0): at such gaps d/eps^2 would only amplify the
eigensolver's rounding.
For any function invariant under rotations inside a degenerate subspace of
equal occupation (the density matrix is), the broadened rule gives the
exact derivative -- in exact arithmetic. In floating point the pairs of a
degenerate level that the SCF splits by rounding (benzene's e1g, e2g, e1u,
e2u levels) get F ~ 1/d, which multiplies the rounding of V^T Vbar: on
benzene that alone broke the forces' mirror symmetry by 1e-5 Ha/Bohr
(def2-SVP) and by more than the forces themselves (STO-3G).
`eigh_density` therefore gives the density matrix P = V diag(occ) V^T its
own rule, the same one multiplied out: dP = V (Gamma o (V^T dA V)) V^T
with Gamma_ab = (occ_b - occ_a) F_ab, which is exactly 0 for equal
occupations however close the eigenvalues are (the Daleckii-Krein formula
of a spectral function, with the reference's broadening where occupations
differ).

Complex Hermitian matrices (the Bloch Fock matrices of a k-point cell,
where degenerate bands are the rule at Gamma and at the zone boundary)
take the same rules with conjugate transposes in place of transposes and
the Hermitian part in place of the symmetric one (`.mH` is `.mT` on a real
tensor, so the real rules keep their bits); Gamma is real and symmetric,
so the density rule stays its own adjoint, and it stays exactly 0 for
equal occupations. The cotangents follow torch's convention for complex
tensors (d/d Re + i d/d Im of a real loss).

The eigenvector polish of the JAX package has no counterpart: it repairs
f32-grade eigenvectors of an f64 solve on the TPU, while
torch.linalg.eigh in float64 (LAPACK on the CPU, cuSOLVER on the card) is
full precision.
"""
from __future__ import annotations

import torch

_EPS = 1e-12
# gaps below _ROUND * eps * max|w| are rounding, not structure
_ROUND = 1024


def _sym(a):
    """The Hermitian part (the symmetric part of a real matrix)."""
    return 0.5 * (a + a.mH)


def _eigh_vjp(w, v, wbar, vbar):
    d = w[..., None, :] - w[..., :, None]          # d_ab = w_b - w_a
    # a gap at the rounding level of the eigensolver stands for an exact
    # degeneracy, where the rule gives F = 0; kept, d/eps^2 (~1e9 at a
    # gap of 1e-15) would multiply rounding noise of V^T Vbar
    tiny = _ROUND * torch.finfo(w.dtype).eps * w.abs().amax(-1, keepdim=True)
    f = torch.where(d.abs() > tiny[..., None], d / (d * d + _EPS * _EPS),
                    torch.zeros_like(d))
    f = f * (1.0 - torch.eye(w.shape[-1], dtype=w.dtype, device=w.device))
    inner = f * (v.mH @ vbar) + torch.diag_embed(wbar).to(v.dtype)
    return _sym(v @ inner @ v.mH)


class _SafeEigh(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a):
        w, v = torch.linalg.eigh(a)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, wbar, vbar):
        w, v = ctx.saved_tensors
        return _eigh_vjp(w, v, wbar, vbar)


def safe_eigh(a):
    """(eigenvalues ascending, eigenvectors in columns) of a symmetric
    matrix or a batch of them, with the degenerate-safe derivative rule."""
    return _SafeEigh.apply(a)


def _density_vjp(w, v, occ, pbar):
    """Abar of P = V diag(occ) V^T at the eigenpairs (w, V) of A."""
    d = w[..., None, :] - w[..., :, None]          # d_ab = w_b - w_a
    docc = occ[..., None, :] - occ[..., :, None]   # occ_b - occ_a
    gam = torch.where(docc != 0, docc * d / (d * d + _EPS * _EPS),
                      torch.zeros_like(d))
    g = v.mH @ _sym(pbar) @ v
    return v @ (gam * g) @ v.mH


class _EighDensity(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, occ):
        w, v = torch.linalg.eigh(a)
        p = (v * occ[..., None, :]) @ v.mH
        ctx.save_for_backward(w, v, occ)
        return p, w, v

    @staticmethod
    def backward(ctx, pbar, wbar, vbar):
        w, v, occ = ctx.saved_tensors
        abar = _density_vjp(w, v, occ, pbar) + _eigh_vjp(w, v, wbar, vbar)
        occbar = None
        if ctx.needs_input_grad[1]:
            occbar = torch.diagonal(v.mH @ pbar @ v, dim1=-2,
                                    dim2=-1).real
        return abar, occbar


def eigh_density(a, occ):
    """(P = V diag(occ) V^H, w, V) of a Hermitian matrix (or a batch: the
    complex per-k Fock matrices of scf/kpbc.py) and
    occupations aligned to the ascending eigenvalues w. P's derivative is
    exact for degenerate levels of equal occupation (module docstring);
    w and V keep safe_eigh's rule. Double backward goes through the saved
    (w, V), so its second-order terms keep safe_eigh's rule."""
    return _EighDensity.apply(a, occ)
