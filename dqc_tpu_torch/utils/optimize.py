"""BFGS on a torch function, for the variational SCF and optimal_geometry.

The JAX package minimises with jax.scipy.optimize.minimize (BFGS, a
gradient-norm stop). Here scipy's BFGS iterates on a host float64 vector
while the function and its gradient come from torch autograd on the
function's device: one host transfer per evaluation.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize
import torch


def minimize_bfgs(fn, x0, maxiter: int, gtol: float):
    """x minimising fn, from x0, by BFGS; stops when max|grad| <= gtol or
    after maxiter iterations (or when the line search can make no progress
    at the function's rounding level).

    fn: tensor (n,) on x0's device -> scalar tensor, differentiable.
    Returns (x on x0's device, info): info has iterations, evaluations,
    status and message (scipy's) and grad_max_abs at the returned x."""
    dev, dt = x0.device, x0.dtype

    def fun(xh):
        with torch.enable_grad():
            x = torch.as_tensor(xh, dtype=dt, device=dev).requires_grad_(True)
            e = fn(x)
            (g,) = torch.autograd.grad(e, x)
        out = torch.cat([e.detach().reshape(1), g.reshape(-1)]).cpu().numpy()
        return float(out[0]), out[1:]

    res = scipy.optimize.minimize(
        fun, x0.detach().reshape(-1).cpu().numpy(), jac=True, method="BFGS",
        options={"maxiter": maxiter, "gtol": gtol})
    info = {"iterations": int(res.nit), "evaluations": int(res.nfev),
            "status": int(res.status), "message": str(res.message),
            "grad_max_abs": float(np.abs(res.jac).max())}
    return torch.as_tensor(res.x, dtype=dt, device=dev), info
