"""Density fitting (resolution of the identity) for J and K.

Counterpart of dqc_tpu/scf/df.py: Coulomb-metric fitting with j2c =
(P|g|Q) and j3c = (ab|g|P), g = 1/r12, or erf(omega r12)/r12 for the
long-range exchange of a range-separated hybrid (the fit holds per kernel
when the metric and the integrals use the same one).

The JAX package keeps j3c and v_inv = j2c^-1, an eigh pseudo-inverse on the
spectrum above 1e-12 of its largest eigenvalue. theta here keeps only one
tensor B with sum_Q B_Q x B_Q = j3c v_inv j3c:

    J = sum_Q B_Q <B_Q, dm>,    K = sum_Q B_Q dm B_Q   (per spin).

Coulomb metric: j2c = L L^T by Cholesky and B = L^-1 j3c. While the cutoff
drops nothing this is the same function as the JAX package's, and its
derivative (through cholesky and solve_triangular) has no term in
1/(w_i - w_j), which the eigenvector rule would put into the derivative
wherever the metric has degenerate eigenvalues (any symmetric molecule). A
Coulomb metric whose smallest/largest eigenvalue ratio is at or below the
cutoff, where the JAX package would drop functions, raises.

erf-attenuated metric (omega): the long-range kernel cannot tell tight
functions on one atom apart, so its metric is singular to rounding for
every molecule (ratio -1.8e-18 on H2O/STO-3G autoaux at omega 0.33) and the
JAX package's cutoff always drops functions. The port computes that same
pseudo-inverse: B = j2c^(+1/2) j3c with j2c^(+1/2) = V f(w) V^T, f(w) =
w^-1/2 on the kept spectrum and 0 below it. Its derivative is the
Daleckii-Krein rule of that spectral function, whose divided differences
(f(w_a) - f(w_b))/(w_a - w_b) stay finite for degenerate eigenvalues
(-1/(s_a s_b (s_a + s_b)), s = w^1/2, for two kept ones).

B is laid out (nao, naux, nao), B[i, Q, k] = B_Q[i, k]: with B_Q symmetric,
B.reshape(nao, naux * nao) and B.reshape(nao * naux, nao) are the two
matrices RI-K needs, so both of its products are single GEMMs that read B
with no copy, and J is a batched GEMV and one vector-matrix product. The
contractions are plain torch, as they are XLA einsums in the JAX package.
"""
from __future__ import annotations

import time

import torch

from ..ops.eri import coul2c, coul3c
from ..ops.shellstruct import tri_pair_classes
from .eigh import _eigh_vjp, _sym

# the JAX package's pseudo-inverse keeps eigenvalues w > METRIC_CUTOFF * w_max
METRIC_CUTOFF = 1e-12


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def metric_ratio(j2c) -> float:
    """Smallest over largest eigenvalue of the fitting metric (detached)."""
    w = torch.linalg.eigvalsh(j2c.detach())
    return float(w[0] / w[-1])


def _pinv_sqrt_vjp(w, v, keep, pbar):
    """Abar of P = V f(w) V^T (f = w^-1/2 on keep, else 0) at the eigenpairs
    (w, V) of A: V (G o (V^T sym(Pbar) V)) V^T with the divided
    differences G of f."""
    one = torch.ones_like(w)
    s = torch.sqrt(torch.where(keep, w, one))
    f = torch.where(keep, 1.0 / s, torch.zeros_like(w))
    kk = keep[:, None] & keep[None, :]
    mixed = keep[:, None] ^ keep[None, :]
    d = w[:, None] - w[None, :]
    g_kk = -1.0 / (s[:, None] * s[None, :] * (s[:, None] + s[None, :]))
    g_mixed = (f[:, None] - f[None, :]) / torch.where(mixed, d,
                                                      torch.ones_like(d))
    g = torch.where(kk, g_kk, torch.where(mixed, g_mixed,
                                          torch.zeros_like(d)))
    return v @ (g * (v.T @ _sym(pbar) @ v)) @ v.T


class _PinvSqrt(torch.autograd.Function):
    """(P = V f(w) V^T, w, V) of a symmetric matrix A, f(w) = w^-1/2 for w >
    cutoff * w_max and 0 below. The backward is written in the saved
    outputs w and V, so it differentiates again (its second-order terms
    through V take safe_eigh's rule)."""

    @staticmethod
    def forward(ctx, a, cutoff):
        w, v = torch.linalg.eigh(a)
        keep = w > cutoff * w[-1]
        f = torch.where(keep, torch.rsqrt(torch.where(keep, w,
                                                      torch.ones_like(w))),
                        torch.zeros_like(w))
        p = (v * f[None, :]) @ v.T
        ctx.save_for_backward(w, v)
        ctx.cutoff = cutoff
        return p, w, v

    @staticmethod
    def backward(ctx, pbar, wbar, vbar):
        w, v = ctx.saved_tensors
        keep = (w > ctx.cutoff * w[-1]).detach()
        abar = _pinv_sqrt_vjp(w, v, keep, pbar) + _eigh_vjp(w, v, wbar, vbar)
        return abar, None


def pinv_sqrt(a, cutoff: float = METRIC_CUTOFF):
    """(j2c^(+1/2), eigenvalues) of a symmetric metric: the square root of
    its pseudo-inverse on the eigenvalues above cutoff * w_max."""
    p, w, _ = _PinvSqrt.apply(a, cutoff)
    return p, w


def build_df_theta(meta, params, meta_aux, params_aux, omega=None):
    """({'B': (nao, naux, nao)}, info) for the fit of the orbital basis
    (meta, params) in the aux basis (meta_aux, params_aux); omega: the
    erf-attenuated kernel and metric instead of the Coulomb one.

    info: seconds of the metric (coul2c_s), of the 3-centre integrals
    (coul3c_s, over coul3c_classes = [shell-pair classes, aux classes]) and
    of the factorisation and solve (factor_s), naux, the
    metric's eigenvalue ratio, and the number of aux functions the fit
    keeps (naux_kept). The Coulomb fit raises NotImplementedError where the
    ratio is at or below METRIC_CUTOFF; the attenuated fit drops those
    functions as the JAX package does (module docstring)."""
    dev = params["atompos"].device
    naux = meta_aux.nao
    t0 = time.perf_counter()
    j2c = coul2c(meta_aux, params_aux, omega=omega)
    _sync(dev)
    t1 = time.perf_counter()
    j3c = coul3c(meta, params, meta_aux, params_aux, omega=omega)
    _sync(dev)
    t2 = time.perf_counter()
    info = {"coul2c_s": t1 - t0, "coul3c_s": t2 - t1, "naux": naux,
            "coul3c_classes": [len(tri_pair_classes(meta)),
                               len(meta_aux.classes)]}
    if omega is not None:
        ph, w = pinv_sqrt(j2c)
        del j2c
        # B[i] = j2c^(+1/2) j3c[i]^T, (naux, nao)
        b = torch.matmul(ph, j3c.transpose(1, 2))
        del j3c
        _sync(dev)
        w = w.detach()
        info.update(factor_s=time.perf_counter() - t2,
                    metric_ratio=float(w[0] / w[-1]),
                    naux_kept=int((w > METRIC_CUTOFF * w[-1]).sum()))
        return {"B": b}, info
    ratio = metric_ratio(j2c)
    if not ratio > METRIC_CUTOFF:
        raise NotImplementedError(
            f"density-fitting Coulomb metric has smallest/largest "
            f"eigenvalue ratio {ratio:.3e}, at or below {METRIC_CUTOFF}: the "
            "JAX package would drop the functions under its cutoff, which "
            "the port's Cholesky fit of the Coulomb metric does not (ROADMAP "
            "queue C)")
    L = torch.linalg.cholesky(j2c)
    del j2c
    # per orbital row i: B[i] = L^-1 j3c[i]^T, (naux, nao)
    b = torch.linalg.solve_triangular(L, j3c.transpose(1, 2), upper=False)
    del j3c
    b = b.contiguous()
    _sync(dev)
    info.update(factor_s=time.perf_counter() - t2, metric_ratio=ratio,
                naux_kept=naux)
    return {"B": b}, info


def df_j(df, dm_tot):
    """Coulomb matrix of the fitted density: J = sum_Q B_Q <B_Q, dm>. A
    batch (B (nb, nao, naux, nao), dm (nb, nao, nao)) member by member."""
    b = df["B"]
    if b.ndim == 4:
        rho = torch.einsum("...iqk,...ik->...q", b, dm_tot)
        return torch.einsum("...q,...iqk->...ik", rho, b)
    rho = torch.bmm(b, dm_tot[:, :, None]).sum(dim=0)[:, 0]   # (naux,)
    return torch.matmul(rho, b)


def df_k(df, dm, polarized=None):
    """RI-K exchange: K = sum_Q B_Q dm B_Q for dm (nao, nao), or per spin
    for dm (2, nao, nao) (polarized; by default a dm with one axis more
    than a matrix). A batch (B (nb, nao, naux, nao)) takes dm (nb, [2,]
    nao, nao). One intermediate U[k,Q,j] = (dm B_Q)[k,j] of B's size. A
    periodic fit that carries 'madelung' (scf/pbc.build_pbc_gdf) adds the
    dropped G = 0 term of the exchange, M S dm S with its 'ovlp' (exxdiv
    "ewald", as ops/pbcft.aft_k)."""
    b = df["B"]
    batched = b.ndim == 4
    if polarized is None:
        polarized = dm.ndim == 3 + batched
    if polarized:
        return torch.stack([df_k(df, d, False) for d in dm.unbind(-3)],
                           dim=-3)
    nao = b.shape[-1]
    if batched:
        nb = b.shape[0]
        u = dm @ b.reshape(nb, nao, -1)
        k = b.reshape(nb, -1, nao).mT @ u.reshape(nb, -1, nao)
    else:
        u = dm @ b.reshape(nao, -1)
        k = b.reshape(-1, nao).T @ u.reshape(-1, nao)
    if "madelung" in df:
        s = df["ovlp"]
        k = k + df["madelung"] * (s @ dm @ s)
    return k
