"""BFGS on a torch function, for the variational SCF and optimal_geometry.

The JAX package minimises with jax.scipy.optimize.minimize (BFGS, a
gradient-norm stop). Here the BFGS iterates on a host float64 vector while
the function and its gradient come from torch autograd on the function's
device: one host transfer per evaluation. The iteration is scipy's BFGS
(scipy/optimize/_optimize.py::_minimize_bfgs: its Wolfe line search, its
stops and status codes) with the inverse-Hessian update written as two
rank-one terms, O(n^2) per iteration, where scipy's forms two n x n
products, O(n^3): at the 3,906 parameters of two benzene members of the
batched variational SCF (parallel/batch.py) scipy's update took about a
second per iteration on the host. The unbatched variational SCF and
api/properties.optimal_geometry run the same loop. Needs scipy >= 1.8.
"""
from __future__ import annotations

import numpy as np
import torch

# scipy's own line search, from its private module (scipy >= 1.8, where
# scipy/optimize/_optimize.py holds it)
from scipy.optimize._optimize import _LineSearchError, _line_search_wolfe12

_MESSAGES = {0: "Optimization terminated successfully.",
             1: "Maximum number of iterations has been exceeded.",
             2: "Desired error not necessarily achieved due to precision "
                "loss.",
             3: "NaN result encountered."}


def minimize_bfgs(fn, x0, maxiter: int, gtol: float):
    """x minimising fn, from x0, by BFGS; stops when max|grad| <= gtol or
    after maxiter iterations (or when the line search can make no progress
    at the function's rounding level).

    fn: tensor (n,) on x0's device -> scalar tensor, differentiable.
    Returns (x on x0's device, info): info has iterations, evaluations,
    status and message (scipy's codes) and grad_max_abs at the returned x."""
    dev, dt = x0.device, x0.dtype
    last = {}

    def evaluate(xh):
        """(f, g) at xh, computed once per point (the line search asks for
        f and g apart)."""
        if last.get("x") is None or not np.array_equal(last["x"], xh):
            with torch.enable_grad():
                x = torch.as_tensor(xh, dtype=dt,
                                    device=dev).requires_grad_(True)
                e = fn(x)
                (g,) = torch.autograd.grad(e, x)
            out = torch.cat([e.detach().reshape(1),
                             g.reshape(-1)]).cpu().numpy()
            last.update(x=np.array(xh), f=float(out[0]), g=out[1:],
                        n=last.get("n", 0) + 1)
        return last["f"], last["g"]

    def f(xh):
        return evaluate(xh)[0]

    def fprime(xh):
        return evaluate(xh)[1]

    xk = x0.detach().reshape(-1).cpu().numpy().astype(np.float64)
    old_fval, gfk = evaluate(xk)
    hk = np.eye(len(xk))
    # the initial step guess dx ~ 1, as scipy's
    old_old_fval = old_fval + np.linalg.norm(gfk) / 2
    k, status = 0, 0
    gnorm = np.max(np.abs(gfk))
    while gnorm > gtol and k < maxiter:
        pk = -hk @ gfk
        try:
            alpha, _, _, old_fval, old_old_fval, gfkp1 = \
                _line_search_wolfe12(f, fprime, xk, pk, gfk, old_fval,
                                     old_old_fval, amin=1e-100, amax=1e100)
        except _LineSearchError:
            status = 2
            break
        sk = alpha * pk
        xk = xk + sk
        if gfkp1 is None:
            gfkp1 = fprime(xk)
        yk = gfkp1 - gfk
        gfk = gfkp1
        k += 1
        gnorm = np.max(np.abs(gfk))
        if gnorm <= gtol or alpha * np.linalg.norm(pk) <= 0.0:
            break
        if not np.isfinite(old_fval):
            status = 2
            break
        sy = yk @ sk
        rho = 1000.0 if sy == 0.0 else 1.0 / sy
        # (I - rho s y^T) H (I - rho y s^T) + rho s s^T for a symmetric H
        hy = hk @ yk
        hk += ((rho * rho * (yk @ hy) + rho) * np.outer(sk, sk)
               - rho * (np.outer(hy, sk) + np.outer(sk, hy)))
    if status != 2:
        if k >= maxiter:
            status = 1
        elif np.isnan(gnorm) or np.isnan(old_fval) or np.isnan(xk).any():
            status = 3
    gmax = float(np.max(np.abs(gfk)))
    info = {"iterations": k, "evaluations": last["n"], "status": status,
            "message": _MESSAGES[status], "grad_max_abs": gmax}
    return torch.as_tensor(xk, dtype=dt, device=dev), info
