"""User-defined (for example neural-network) XC functionals (counterpart
of dqc_tpu/xc/custom.py).

The functional is a torch function `fn(params, dens) -> e(r)` of a dict of
parameter tensors and a dict of densities; its parameters travel in
theta['xc_params'][key], so `energy_grad()['xc_params']` differentiates the
SCF energy in them through the implicit fixed point.

dens keys: 'rho' (or 'rho_u'/'rho_d'), and by family 'sigma'
('sigma_uu'/'sigma_ud'/'sigma_dd') from 2 on, 'lapl' and 'tau' (spin
variants) from 4 on.
"""
from __future__ import annotations

from typing import Callable

from .base import BaseXC


class CustomXC(BaseXC):
    def __init__(self, fn: Callable, params, family: int = 1,
                 key: str = "custom", exx_fraction: float = 0.0):
        self.fn = fn
        self.init_params = params
        self.family = family
        self.key = key
        self.exx_fraction = exx_fraction

    def _params(self, xcparams):
        if xcparams and self.key in xcparams:
            return xcparams[self.key]
        return self.init_params

    # xc/integrate calls apply_* with theta's xc_params dict
    def apply_unpol(self, xcparams, rho, sigma=None, lapl=None, tau=None):
        d = {"rho": rho}
        if self.family >= 2:
            d["sigma"] = sigma
        if self.family >= 4:
            d.update(lapl=lapl, tau=tau)
        return self.fn(self._params(xcparams), d)

    def apply_pol(self, xcparams, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, lapl_u=None, lapl_d=None, tau_u=None,
                  tau_d=None):
        d = {"rho_u": rho_u, "rho_d": rho_d}
        if self.family >= 2:
            d.update(sigma_uu=sigma_uu, sigma_ud=sigma_ud, sigma_dd=sigma_dd)
        if self.family >= 4:
            d.update(lapl_u=lapl_u, lapl_d=lapl_d, tau_u=tau_u, tau_d=tau_d)
        return self.fn(self._params(xcparams), d)
