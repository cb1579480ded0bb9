"""SCF fixed-point solver: DIIS-accelerated self-consistency loop.

Counterpart of dqc_tpu/scf/fixed_point.py, forward only: the
implicit-function derivative rule comes with a later part of the port.
The loop is a Python loop; ring buffers, the masked least-squares solve, the
conditioning guard, best-iterate tracking, the non-finite freeze and the
patience exit keep the meaning they have in the JAX package, so iteration
counts and residual histories can be compared.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SCFOptions(NamedTuple):
    maxiter: int = 80
    # max |X^T(F D S - S D F)X| convergence target. 1e-8 is the standard
    # production criterion (the energy error is quadratic in the commutator).
    tol: float = 1e-8
    diis_size: int = 10
    diis_start: int = 1
    damping: float = 0.0        # simple mixing fraction of old Fock
    method: str = "diis"        # "diis"; "variational" is not ported yet
    var_maxiter: int = 400      # (variational mode, not ported yet)
    orb_param: str = "matexp"   # (variational mode, not ported yet)
    # mixed precision: accepted for parity of the options and ignored — the
    # f32 warm phase of the JAX package pays for f64 emulation on the TPU;
    # the card has f64 arithmetic in hardware
    mixed: bool = True
    mixed_tol: float = 3e-5
    mixed_maxiter: int = 40
    # PBC exact-exchange divergence treatment; ignored for molecules
    exxdiv: str = "ewald"
    # initial guess above the in-graph size of the JAX package: "sad" is the
    # default there; the port takes "gwh" (generalized Wolfsberg-Helmholtz
    # Fock) until the grid and XC stack bring the atomic LDA that SAD runs
    guess: str = "sad"
    # stall guard: stop when the error has not improved for this many
    # iterations (the loop returns the BEST iterate seen, not the last).
    # 0 = disabled.
    diis_patience: int = 12


def diis_solve(step_and_err: Callable, f0, opts: SCFOptions):
    """Generic CDIIS loop on a flattened state vector.

    step_and_err(f) -> (next Fock from the plain SC map, DIIS error tensor,
    typically X^T [F,D,S] X). f0: initial state tensor.
    Returns (f_in, f_raw, n_iter, best_err, err_hist) for the BEST iterate
    seen (err_hist: (maxiter,) per-iteration residuals, NaN beyond the exit
    iteration):

      f_in  — the loop input that produced it. Pair-consistent: the state
              derived from f_in (dm in SCF) is the one whose residual is
              best_err. Use for final answers.
      f_raw — the SC-map output step(f_in): one extra map application.
    """
    shape = f0.shape
    ff = f0.reshape(-1)
    dtype, dev = ff.dtype, ff.device
    n = ff.shape[0]
    H = opts.diis_size
    tiny = torch.finfo(dtype).tiny
    eps = torch.finfo(dtype).eps

    def step_flat(x):
        f_new, e_new = step_and_err(x.reshape(shape))
        return f_new.reshape(-1), e_new.reshape(-1)

    fhist = torch.zeros((H, n), dtype=dtype, device=dev)
    ehist = None
    eye_h = torch.eye(H, dtype=torch.bool, device=dev)
    ar_h = torch.arange(H, device=dev)
    errh = torch.full((opts.maxiter,), float("nan"), dtype=dtype, device=dev)

    def solve_c(B, mask):
        maskf = mask.to(dtype)
        scale = torch.clamp(
            torch.max(torch.abs(B) * maskf[:, None] * maskf[None, :]),
            min=tiny)
        Bn = B / scale
        mask2 = mask[:, None] & mask[None, :]
        Bn = torch.where(mask2, Bn, eye_h.to(dtype))
        A = torch.zeros((H + 1, H + 1), dtype=dtype, device=dev)
        A[:H, :H] = Bn
        A[:H, H] = maskf
        A[H, :H] = maskf
        rhs = torch.zeros((H + 1,), dtype=dtype, device=dev)
        rhs[H] = 1.0
        # symmetric-eigh pseudo-inverse; rcond as in pinv(rcond=1e-12): near
        # the floor the error vectors are nearly dependent, and a cutoff of
        # 100*eps would keep noise directions whose amplified coefficients
        # stall the extrapolation
        ew, ev = torch.linalg.eigh(A)
        rcond = max(100 * eps, 1e-12)
        cutoff = rcond * torch.max(torch.abs(ew))
        big = torch.abs(ew) > cutoff
        inv_w = torch.where(big, 1.0 / torch.where(big, ew,
                                                   torch.ones_like(ew)),
                            torch.zeros_like(ew))
        return (ev @ (inv_w * (ev.T @ rhs)))[:H] * maskf

    it = 0
    nfill = 0
    slot_bad = [False] * H      # ring-buffer slots holding a non-finite iterate
    best_in, best_raw = ff, ff
    best_err = float("inf")
    best_it = 0
    while True:
        go = it < opts.maxiter and best_err > opts.tol
        if opts.diis_patience > 0:
            go = go and (it - best_it <= opts.diis_patience)
        if not go:
            break
        f_raw, e_new = step_flat(ff)
        if ehist is None:
            ehist = torch.zeros((H, e_new.shape[0]), dtype=e_new.dtype,
                                device=dev)
        # errnorm belongs to the PAIR (f_raw, state(ff)): step_and_err
        # derives the density from the INPUT ff and measures the new Fock's
        # commutator against it
        f_new = ((1.0 - opts.damping) * f_raw + opts.damping * ff
                 if opts.damping > 0.0 else f_raw)
        errnorm = float(torch.max(torch.abs(e_new)))   # the one host sync
        errh[it] = errnorm
        # push into ring buffers
        slot = it % H
        fhist[slot] = f_new
        ehist[slot] = e_new
        nfill = min(nfill + 1, H)
        # DIIS extrapolation over filled slots (uniform scaling keeps the
        # constrained least-squares solution exact)
        filled = ar_h < nfill
        finite = errnorm == errnorm and abs(errnorm) != float("inf")
        slot_bad[slot] = not finite
        if any(slot_bad):
            # a non-finite iterate poisons the history until its slot is
            # overwritten: the extrapolation is non-finite too (eigh would
            # refuse the matrix), and the next iterate is thrown away below
            f_diis = torch.full_like(ff, float("nan"))
        else:
            B = ehist @ ehist.T
            c = solve_c(B, filled)
            # conditioning guard: blown-up coefficients amplify noise in
            # the Fock combination — re-solve on the most recent <=4
            # iterates
            age = torch.remainder(it - ar_h, H)
            c_recent = solve_c(B, filled & (age < 4))
            c = torch.where(torch.sum(torch.abs(c)) > 20.0, c_recent, c)
            f_diis = c @ fhist
        ff_next = f_diis if it + 1 >= opts.diis_start else f_new
        # best-iterate tracking: a diverging extrapolation must not discard
        # the best state seen; non-finite iterates never become "best"
        if finite and errnorm < best_err:
            best_in, best_raw = ff, f_raw
            best_err, best_it = errnorm, it
        if not finite:
            # a non-finite iterate poisons the history; freeze on the best
            ff_next = best_in
        ff = ff_next
        it += 1
    return (best_in.reshape(shape), best_raw.reshape(shape), it,
            best_err, errh)
