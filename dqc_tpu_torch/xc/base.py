"""XC functional interface and composition algebra (counterpart of
dqc_tpu/xc/base.py).

Functionals are plain torch energy-density functions; potentials come from
torch.autograd. Conventions (those of libxc):
  family: 1=LDA, 2=GGA, 4=MGGA
  polarized inputs: rho_u, rho_d, sigma_uu, sigma_ud, sigma_dd (+ lapl_*,
  tau_* for MGGA); sigma = |grad n|^2 contractions.
  edens(...) returns the energy density per unit volume e(r):
  E_xc = int e(r) d^3r.
"""
from __future__ import annotations

import torch


def _merge_exx_lr(a, b):
    """Combine ((coef, omega), ...) tuples, summing coefs of equal omegas
    (each distinct omega costs one attenuated K build in the engine)."""
    out = list(a)
    for coef, om in b:
        for i, (c0, o0) in enumerate(out):
            if abs(o0 - om) <= 1e-12 * max(abs(o0), abs(om), 1.0):
                out[i] = (c0 + coef, o0)
                break
        else:
            out.append((coef, om))
    return tuple((c, o) for (c, o) in out if c != 0.0)


class BaseXC:
    family: int = 1
    exx_fraction: float = 0.0   # hybrid exact-exchange weight
    # range-separated exact exchange: ((coef, omega), ...) adds
    # coef * K_lr(omega) with the long-range erf(omega r)/r kernel
    exx_lr: tuple = ()

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, lapl_u=None, lapl_d=None,
                  tau_u=None, tau_d=None):
        raise NotImplementedError

    def edens_unpol(self, rho, sigma=None, lapl=None, tau=None):
        """Default: the exact spin-unpolarized limit of edens_pol."""
        half = 0.5 * rho
        kw = {}
        if self.family >= 2:
            q = 0.25 * sigma
            kw.update(sigma_uu=q, sigma_ud=q, sigma_dd=q)
        if self.family >= 4:
            kw.update(lapl_u=0.5 * lapl, lapl_d=0.5 * lapl,
                      tau_u=0.5 * tau, tau_d=0.5 * tau)
        return self.edens_pol(half, half, **kw)

    def __add__(self, other):
        return AddXC(self, other)

    def __mul__(self, f):
        if isinstance(f, (int, float)):
            return MulXC(self, float(f))
        raise TypeError("XC can only be scaled by a number")

    __rmul__ = __mul__


class AddXC(BaseXC):
    def __init__(self, a: BaseXC, b: BaseXC):
        self.a, self.b = a, b
        self.family = max(a.family, b.family)
        self.exx_fraction = a.exx_fraction + b.exx_fraction
        self.exx_lr = _merge_exx_lr(a.exx_lr, b.exx_lr)

    def edens_pol(self, *args, **kw):
        return self.a.edens_pol(*args, **kw) + self.b.edens_pol(*args, **kw)

    def edens_unpol(self, *args, **kw):
        return self.a.edens_unpol(*args, **kw) + self.b.edens_unpol(*args, **kw)


class MulXC(BaseXC):
    def __init__(self, a: BaseXC, f: float):
        self.a, self.f = a, f
        self.family = a.family
        self.exx_fraction = f * a.exx_fraction
        self.exx_lr = tuple((f * c, o) for (c, o) in a.exx_lr)

    def edens_pol(self, *args, **kw):
        return self.f * self.a.edens_pol(*args, **kw)

    def edens_unpol(self, *args, **kw):
        return self.f * self.a.edens_unpol(*args, **kw)


class HFExchangeXC(BaseXC):
    """Pure exact exchange: contributes only exx_fraction (the K build is
    the SCF engine's). Lets "0.2*hf + 0.8*gga_x_b88" compose."""
    family = 1
    exx_fraction = 1.0

    def edens_pol(self, rho_u, rho_d, **kw):
        return torch.zeros_like(rho_u)

    def edens_unpol(self, rho, **kw):
        return torch.zeros_like(rho)



class LRHFExchangeXC(BaseXC):
    """Long-range exact exchange with the erf(omega r12)/r12 kernel:
    contributes only exx_lr (the attenuated K build is the SCF engine's).
    "0.19*hf + 0.46*lr_hf(0.33) + <short-range DFT part>" is the CAM-B3LYP
    exchange split; "0.25*hf + -0.25*lr_hf(0.11) + ..." a screened
    (short-range only) exact exchange."""
    family = 1

    def __init__(self, omega: float):
        self.exx_lr = ((1.0, float(omega)),)

    def edens_pol(self, rho_u, rho_d, **kw):
        return torch.zeros_like(rho_u)

    def edens_unpol(self, rho, **kw):
        return torch.zeros_like(rho)
