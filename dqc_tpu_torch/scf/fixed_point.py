"""SCF fixed-point solver: DIIS-accelerated self-consistency loop, and the
implicit-function derivative of its fixed point.

Counterpart of dqc_tpu/scf/fixed_point.py. The loop is a Python loop over
a batch of states (diis_solve_batch; diis_solve is the batch of one); ring
buffers, the masked least-squares solve, the conditioning guard,
best-iterate tracking, the non-finite freeze and the patience exit keep the
meaning they have in the JAX package, per member as under its jax.vmap,
so iteration counts and residual histories can be compared.

`implicit_fixed_point(step, solver, theta, x0)` is the counterpart of the
JAX package's custom_jvp of the same name (and of the GMRES adjoint of its
scf/adjoint.py): a torch.autograd.Function over theta's floating tensor
leaves whose forward runs `solver` under no_grad and whose backward solves
(I - d step/dx)^T lam = xbar by restarted GMRES (`gmres`), then forms
thetabar = (d step/d theta)^T lam by autograd. The linear solve is itself a
Function (`_LinSolve`) whose backward is the other solve (the untransposed
one for the adjoint, and back), the role custom_linear_solve's
transpose_solve plays in the JAX package. Every backward here is made of
that Function and of autograd of step at stand-ins for x and theta, which
are views of them when the backward is itself recorded (a graph-building
backward: create_graph=True); so derivatives of any order are exact at the
fixed point (Hessians, and the third derivatives of a Raman spectrum), not
derivatives of GMRES's iterations.
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch


class SCFOptions(NamedTuple):
    maxiter: int = 80
    # max |X^T(F D S - S D F)X| convergence target. 1e-8 is the standard
    # production criterion (the energy error is quadratic in the commutator).
    tol: float = 1e-8
    diis_size: int = 10
    diis_start: int = 1
    damping: float = 0.0        # simple mixing fraction of old Fock
    method: str = "diis"        # "diis" or "variational"
    # variational mode: BFGS iterations, and the orbital parametrisation
    # ("matexp", "qr" or "ov"; qccalc.SCF_QCCalc._variational_solver)
    var_maxiter: int = 400
    orb_param: str = "matexp"
    # mixed precision: accepted for parity of the options and ignored — the
    # f32 warm phase of the JAX package pays for f64 emulation on the TPU;
    # the card has f64 arithmetic in hardware
    mixed: bool = True
    mixed_tol: float = 3e-5
    mixed_maxiter: int = 40
    # PBC exact-exchange divergence treatment; ignored for molecules
    exxdiv: str = "ewald"
    # initial guess at and above qccalc.GUESS_NAO: "sad" (superposition of
    # atomic densities, qccalc.sad_dm0) or "gwh" (generalized
    # Wolfsberg-Helmholtz Fock); smaller systems start from the core guess
    guess: str = "sad"
    # stall guard: stop when the error has not improved for this many
    # iterations (the loop returns the BEST iterate seen, not the last).
    # 0 = disabled.
    diis_patience: int = 12


def diis_solve(step_and_err: Callable, f0, opts: SCFOptions):
    """Generic CDIIS loop on a flattened real state vector (a complex
    state, the Bloch Fock matrices of a k-point cell, is carried as stacked
    (re, im), so the history, B and the extrapolation stay real algebra):
    diis_solve_batch of a batch of one.

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
    if f0.is_complex():
        raise TypeError("diis_solve takes a real state; carry a complex one "
                        "as stacked (re, im), as scf/kpbc.py does")

    def step_one(f):
        f_new, e_new = step_and_err(f[0])
        return f_new[None], e_new[None]
    f_in, f_raw, n_iter, best_err, errh = diis_solve_batch(step_one, f0[None],
                                                           opts)
    return f_in[0], f_raw[0], n_iter[0], best_err[0], torch.as_tensor(errh[0])


def _solve_c(B, mask, eye_h):
    """The constrained least-squares DIIS coefficients over the slots in
    use (mask) of one member's error inner products B (H, H): uniform
    scaling, the bordered system, and its symmetric-eigh pseudo-inverse
    with rcond as in pinv(rcond=1e-12): near the floor the error vectors
    are nearly dependent, and a cutoff of 100*eps would keep noise
    directions whose amplified coefficients stall the extrapolation."""
    dtype, dev = B.dtype, B.device
    H = B.shape[0]
    maskf = mask.to(dtype)
    scale = torch.clamp(
        torch.max(torch.abs(B) * maskf[:, None] * maskf[None, :]),
        min=torch.finfo(dtype).tiny)
    Bn = B / scale
    mask2 = mask[:, None] & mask[None, :]
    Bn = torch.where(mask2, Bn, eye_h.to(dtype))
    A = torch.zeros((H + 1, H + 1), dtype=dtype, device=dev)
    A[:H, :H] = Bn
    A[:H, H] = maskf
    A[H, :H] = maskf
    rhs = torch.zeros((H + 1,), dtype=dtype, device=dev)
    rhs[H] = 1.0
    ew, ev = torch.linalg.eigh(A)
    rcond = max(100 * torch.finfo(dtype).eps, 1e-12)
    cutoff = rcond * torch.max(torch.abs(ew))
    big = torch.abs(ew) > cutoff
    inv_w = torch.where(big, 1.0 / torch.where(big, ew, torch.ones_like(ew)),
                        torch.zeros_like(ew))
    return (ev @ (inv_w * (ev.T @ rhs)))[:H] * maskf


def diis_solve_batch(step_and_err: Callable, f0, opts: SCFOptions):
    """The DIIS loop for a batch of independent states f0 (nb, ...): one
    DIIS history, best iterate, patience and non-finite freeze per member,
    as jax.vmap of the JAX package's while_loop keeps them. Every iteration
    steps the whole batch (one launch of each kernel) and makes one host
    sync, the members' residuals; a member that has stopped (tol, maxiter
    or patience) is frozen at its state, as the vmapped loop selects the
    old carry for it, and the loop ends when every member has stopped.
    Members run in lockstep while they run, so they share the ring slot and
    fill count of an iteration. Each member's extrapolation (its H x H
    system) is its own small solve, with the arithmetic of a batch of one.

    Returns (f_in (nb, ...), f_raw (nb, ...), n_iter [nb], best_err [nb],
    err_hist (nb, maxiter) numpy, NaN past each member's exit)."""
    nb = f0.shape[0]
    shape = f0.shape
    ff = f0.reshape(nb, -1)
    dtype, dev = ff.dtype, ff.device
    H = opts.diis_size
    eye_h = torch.eye(H, dtype=torch.bool, device=dev)
    ar_h = torch.arange(H, device=dev)
    fhist = torch.zeros((nb, H, ff.shape[1]), dtype=dtype, device=dev)
    ehist = None
    errh = np.full((nb, opts.maxiter), np.nan)
    # ring-buffer slots holding a non-finite iterate, per member
    slot_bad = np.zeros((nb, H), dtype=bool)
    best_in, best_raw = ff, ff
    best_err = [float("inf")] * nb
    best_it = [0] * nb
    n_iter = [0] * nb
    active = [True] * nb
    it = 0
    while True:
        for m in range(nb):
            if not active[m]:
                continue
            go = it < opts.maxiter and best_err[m] > opts.tol
            if opts.diis_patience > 0:
                go = go and (it - best_it[m] <= opts.diis_patience)
            if not go:
                active[m], n_iter[m] = False, it
        if not any(active):
            break
        f_raw, e_new = step_and_err(ff.reshape(shape))
        f_raw = f_raw.reshape(nb, -1)
        e_new = e_new.reshape(nb, -1)
        if ehist is None:
            ehist = torch.zeros((nb, H, e_new.shape[1]), dtype=e_new.dtype,
                                device=dev)
        # errnorm belongs to the PAIR (f_raw, state(ff)): step_and_err
        # derives the density from the INPUT ff and measures the new Fock's
        # commutator against it
        f_new = ((1.0 - opts.damping) * f_raw + opts.damping * ff
                 if opts.damping > 0.0 else f_raw)
        # the one host sync: every member's residual
        errs = torch.amax(torch.abs(e_new), dim=-1).tolist()
        # push into the ring buffers (a stopped member's are never read)
        slot = it % H
        fhist[:, slot] = f_new
        ehist[:, slot] = e_new
        filled = ar_h < min(it + 1, H)
        age = torch.remainder(it - ar_h, H)
        ff_next = []
        for m in range(nb):
            if not active[m]:
                ff_next.append(ff[m])
                continue
            errh[m, it] = errs[m]
            finite = errs[m] == errs[m] and abs(errs[m]) != float("inf")
            slot_bad[m, slot] = not finite
            if slot_bad[m].any():
                # a non-finite iterate poisons the history until its slot is
                # overwritten: the extrapolation is non-finite too (eigh
                # would refuse the matrix), and the next iterate is thrown
                # away below
                f_diis = torch.full_like(ff[m], float("nan"))
            else:
                # DIIS extrapolation over filled slots (uniform scaling
                # keeps the constrained least-squares solution exact)
                B = ehist[m] @ ehist[m].T
                c = _solve_c(B, filled, eye_h)
                # conditioning guard: blown-up coefficients amplify noise
                # in the Fock combination — re-solve on the most recent <=4
                # iterates
                c_recent = _solve_c(B, filled & (age < 4), eye_h)
                c = torch.where(torch.sum(torch.abs(c)) > 20.0, c_recent, c)
                f_diis = c @ fhist[m]
            nxt = f_diis if it + 1 >= opts.diis_start else f_new[m]
            # best-iterate tracking: a diverging extrapolation must not
            # discard the best state seen; non-finite iterates never become
            # "best"
            if finite and errs[m] < best_err[m]:
                best_err[m], best_it[m] = errs[m], it
                best_in = _put_row(best_in, m, ff[m])
                best_raw = _put_row(best_raw, m, f_raw[m])
            if not finite:
                # a non-finite iterate poisons the history; freeze on the
                # best
                nxt = best_in[m]
            ff_next.append(nxt)
        ff = torch.stack(ff_next)
        it += 1
    return (best_in.reshape(shape), best_raw.reshape(shape), n_iter,
            best_err, errh)


def _put_row(x, m, row):
    """x with row m replaced, as a new tensor (x may be another's view)."""
    x = x.clone()
    x[m] = row
    return x


def gmres(matvec: Callable, b, tol: float = 1e-12, maxiter: int = 200,
          restart: int = 60):
    """Restarted GMRES for matvec(x) = b on flat tensors, on b's device
    (counterpart of dqc_tpu/scf/adjoint.py::_gmres). Warm start at b;
    Arnoldi with classical Gram-Schmidt done twice; the small
    least-squares problems on the host. Returns (x, relative residual,
    matvecs in the Krylov steps)."""
    bn = float(torch.linalg.vector_norm(b))
    if bn == 0.0:
        return torch.zeros_like(b), 0.0, 0
    x = b.clone()
    total = 0
    while total < maxiter:
        r = b - matvec(x)
        beta = float(torch.linalg.vector_norm(r))
        if beta / bn < tol:
            return x, beta / bn, total
        m = min(restart, maxiter - total)
        Q = torch.zeros((m + 1, b.numel()), dtype=b.dtype, device=b.device)
        H = np.zeros((m + 1, m))
        Q[0] = r / beta
        k_done = m
        for k in range(m):
            w = matvec(Q[k])
            h = Q[:k + 1] @ w
            w = w - h @ Q[:k + 1]
            h2 = Q[:k + 1] @ w
            w = w - h2 @ Q[:k + 1]
            H[:k + 1, k] = (h + h2).cpu().numpy()
            H[k + 1, k] = float(torch.linalg.vector_norm(w))
            total += 1
            if H[k + 1, k] < 1e-300:
                k_done = k + 1
                break
            Q[k + 1] = w / H[k + 1, k]
            e1 = np.zeros(k + 2)
            e1[0] = beta
            y = np.linalg.lstsq(H[:k + 2, :k + 1], e1, rcond=None)[0]
            if np.linalg.norm(H[:k + 2, :k + 1] @ y - e1) / bn < tol:
                k_done = k + 1
                break
        e1 = np.zeros(k_done + 1)
        e1[0] = beta
        y = np.linalg.lstsq(H[:k_done + 1, :k_done], e1, rcond=None)[0]
        x = x + torch.as_tensor(y, dtype=b.dtype, device=b.device) @ Q[:k_done]
    r = b - matvec(x)
    return x, float(torch.linalg.vector_norm(r)) / bn, total


# GMRES settings of the adjoint solves (dqc_tpu/scf/adjoint.py:89, :255)
GMRES_TOL = 1e-12
GMRES_MAXITER = 200
GMRES_RESTART = 60
# a solve that ends above this relative residual is reported: the gradient
# error is of the same order
GMRES_WARN = 1e-8


class _Slot:
    def __init__(self, i):
        self.i = i


def _take(t, leaves):
    if isinstance(t, dict):
        return {k: _take(v, leaves) for k, v in t.items()}
    if isinstance(t, torch.Tensor) and (t.is_floating_point()
                                        or t.is_complex()):
        leaves.append(t)
        return _Slot(len(leaves) - 1)
    return t


def _rebuild(spec, ls):
    if isinstance(spec, dict):
        return {k: _rebuild(v, ls) for k, v in spec.items()}
    return ls[spec.i] if isinstance(spec, _Slot) else spec


def _flatten(tree):
    """(floating and complex tensor leaves, rebuild) of a nested dict (the
    complex integrals of a k-point cell are leaves too): rebuild(leaves)
    gives the dict back with those leaves; everything else (bool masks,
    ints) stays in it as it is. Module-level helpers, not recursive
    closures: a closure that calls itself is a reference cycle, and would
    keep what it holds until the cyclic garbage collector runs."""
    leaves = []
    spec = _take(tree, leaves)
    return leaves, functools.partial(_rebuild, spec)


class _Problem(NamedTuple):
    """What the Functions below need besides tensors: the map, the solver,
    how theta is rebuilt from its leaves, and where solve statistics go."""
    step: Callable
    solver: Callable
    rebuild: Callable
    stats: list


def _step_graph(prob, x, leaves, needs=(), x_grad=True):
    """(xd, theta leaves, step(xd, theta)): one graph of step at stand-ins
    for x and theta's leaves, reused by every product of a solve. Outside a
    graph-building backward a stand-in is a detached copy (a leaf requires
    grad where `needs` says so, xd where x_grad does: else no backward
    computes an x cotangent, and the kernels' dm cotangents are launches).
    Inside one (grad mode on: the backward of a higher derivative is being
    recorded), the stand-in of a tensor that requires grad is a view of it,
    so what is formed here stays differentiable in x and theta at the next
    order. Either way autograd.grad in a stand-in is a partial derivative:
    the fixed point's own path from theta to x does not pass through it."""
    create = torch.is_grad_enabled()

    def stand_in(t, grad):
        if create and t.requires_grad:
            return t.view_as(t)
        return t.detach().requires_grad_(bool(grad))

    with torch.enable_grad():
        xd = stand_in(x, x_grad)
        ls = [stand_in(t, n)
              for t, n in zip(leaves, list(needs) + [False] * len(leaves))]
        y = prob.step(xd, prob.rebuild(ls))
    return xd, ls, y


def _vjp_map(xd, y):
    """v -> J^T v on flat tensors, J = d step/dx."""
    def jt(v):
        (g,) = torch.autograd.grad(y, xd, v.reshape(y.shape),
                                   retain_graph=True)
        return g.reshape(-1)
    return jt


def _jvp_map(xd, y):
    """v -> J v on flat tensors: J^T u is linear in u, so its derivative in
    u along v is J v. Builds the graph of J^T u once (create_graph)."""
    with torch.enable_grad():
        u = torch.zeros_like(y, requires_grad=True)
        (jtu,) = torch.autograd.grad(y, xd, u, create_graph=True)

    def jv(v):
        (g,) = torch.autograd.grad(jtu, u, v.reshape(y.shape),
                                   retain_graph=True)
        return g.reshape(-1)
    return jv


def _solve(matvec, b, stats, what):
    """x with matvec(x) = b by GMRES on the normalised rhs; a zero rhs
    (common for symmetry-zero directions) gives zero without a solve."""
    flat = b.reshape(-1)
    bn = float(torch.linalg.vector_norm(flat))
    if bn == 0.0:
        stats.append({"solve": what, "iterations": 0, "rel": 0.0})
        return torch.zeros_like(b)
    x, rel, its = gmres(matvec, flat / bn, tol=GMRES_TOL,
                        maxiter=GMRES_MAXITER, restart=GMRES_RESTART)
    stats.append({"solve": what, "iterations": its, "rel": rel})
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"implicit_fixed_point: the {what} solve gave "
                           "non-finite values")
    if rel > GMRES_WARN:
        warnings.warn(f"implicit_fixed_point: GMRES of the {what} solve "
                      f"ended at a relative residual of {rel:.2e}; the "
                      "derivative error is of the same order",
                      RuntimeWarning, stacklevel=3)
    return (x * bn).reshape(b.shape)


def _pairing(prob, p, q, x, leaves, needs):
    """d/d(x, theta) <q, J^T p>, J = d step/dx at (x, theta), for x
    (needs[0]) and the leaves that needs[1:] marks (None elsewhere), p and
    q held. Inside a graph-building backward the result keeps its graph in
    p, q, x and theta."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xd, ls, y = _step_graph(prob, x, leaves, needs[1:])
        (jtp,) = torch.autograd.grad(y, xd, p, create_graph=True)
        wanted = [xd] + [t for t, n in zip(ls, needs[1:]) if n]
        grads = list(torch.autograd.grad((jtp * q).sum(), wanted,
                                         allow_unused=True,
                                         create_graph=create))
    x_bar = grads.pop(0)
    return ((x_bar if needs[0] else None),
            *(grads.pop(0) if n else None for n in needs[1:]))


class _LinSolve(torch.autograd.Function):
    """z = (I - A)^{-1} b at (x, theta), A = J^T (transpose) or J, with
    J = d step/dx. Its backward is the other solve, w = (I - A^T)^{-1} zbar
    (= bbar), and the cotangents of x and theta are d/d(x, theta) <w, A z>
    with w and z held (dz = (I - A)^{-1} (db + dA z)). The backward is
    itself made of this Function and of autograd of step, so a derivative
    of any order is exact at the fixed point."""

    @staticmethod
    def forward(ctx, prob, transpose, b, x, *leaves):
        xd, _, y = _step_graph(prob, x, leaves)
        mv = _vjp_map(xd, y) if transpose else _jvp_map(xd, y)
        z = _solve(lambda v: v - mv(v), b, prob.stats,
                   "adjoint" if transpose else "transposed")
        ctx.prob, ctx.transpose = prob, transpose
        ctx.save_for_backward(z, x, *leaves)
        return z

    @staticmethod
    def backward(ctx, z_bar):
        prob, transpose = ctx.prob, ctx.transpose
        z, x, *leaves = ctx.saved_tensors
        w = _LinSolve.apply(prob, not transpose, z_bar.contiguous(), x,
                            *leaves)
        # <w, J^T z> for A = J^T; <w, J z> = <z, J^T w> for A = J
        p, q = (z, w) if transpose else (w, z)
        grads = _pairing(prob, p, q, x, leaves, ctx.needs_input_grad[3:])
        return (None, None, w, *grads)


def _theta_vjp(prob, lam, x, leaves, needs):
    """(d step/d theta)^T lam at (x, theta) for the leaves that `needs`
    marks (None elsewhere); inside a graph-building backward it keeps its
    graph in lam, x and theta."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        _, ls, y = _step_graph(prob, x, leaves, needs, x_grad=False)
        want = [t for t, n in zip(ls, needs) if n]
        g = list(torch.autograd.grad(y, want, lam, allow_unused=True,
                                     create_graph=create))
    return [(g.pop(0) if n else None) for n in needs]


class _ImplicitFixedPoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, prob, x0, *leaves):
        with torch.no_grad():
            x = prob.solver(prob.rebuild(list(leaves)), x0)
        ctx.prob = prob
        ctx.save_for_backward(x, *leaves)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        prob = ctx.prob
        x, *leaves = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        if not any(needs):
            return (None, None, *(None for _ in needs))
        lam = _LinSolve.apply(prob, True, x_bar.contiguous(), x, *leaves)
        return (None, None, *_theta_vjp(prob, lam, x, leaves, needs))


def implicit_fixed_point(step: Callable, solver: Callable, theta: dict, x0,
                         stats: list = None):
    """x* with x* = step(x*, theta), differentiable in theta by the implicit
    function theorem (exact at convergence, to any order).

    step: (x, theta) -> x, written in torch ops (every kernel on its path
    has a derivative rule). solver: (theta, x0) -> x*, any algorithm whose
    output satisfies the fixed point; run under no_grad and never
    differentiated. theta: a nested dict; its floating tensors are the
    differentiable inputs. stats: a list that gets one record per GMRES
    solve of the backward ({'solve', 'iterations', 'rel'})."""
    leaves, rebuild = _flatten(theta)
    prob = _Problem(step, solver, rebuild, [] if stats is None else stats)
    return _ImplicitFixedPoint.apply(prob, x0, *leaves)
