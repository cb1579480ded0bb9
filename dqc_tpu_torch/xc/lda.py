"""LDA functionals in torch: Slater exchange, PW92, VWN5, VWN3 (RPA), PZ81
(counterpart of dqc_tpu/xc/lda.py).

Formulas from the original papers: Slater/Dirac exchange; Perdew & Wang
PRB 45, 13244 (1992); Vosko, Wilk & Nusair, Can. J. Phys. 58, 1200 (1980);
Perdew & Zunger PRB 23, 5048 (1981); the short-range Slater exchange of
the erf-split kernel (LDA_X_ERF) after Gill/Adamson and Toulouse & Savin.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.safeops import RHO_EPS, fclip, fmax, safepow
from .base import BaseXC


def _rs(n):
    return (3.0 / (4.0 * np.pi * fmax(n, RHO_EPS))) ** (1.0 / 3.0)


def _zeta(nu, nd):
    n = nu + nd
    return (nu - nd) / fmax(n, RHO_EPS)


class LDA_X(BaseXC):
    """Slater exchange: e = -Cx * 2^(1/3) * (nu^(4/3)+nd^(4/3))."""
    family = 1
    _CX = (3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0)

    def edens_pol(self, rho_u, rho_d, **kw):
        c = self._CX * 2.0 ** (1.0 / 3.0)
        return -c * (safepow(rho_u, 4.0 / 3.0, RHO_EPS)
                     + safepow(rho_d, 4.0 / 3.0, RHO_EPS))

    def edens_unpol(self, rho, **kw):
        return -self._CX * safepow(rho, 4.0 / 3.0, RHO_EPS)


def _pw92_G(rs, A, a1, b1, b2, b3, b4):
    sq = torch.sqrt(rs)
    den = 2.0 * A * (b1 * sq + b2 * rs + b3 * rs * sq + b4 * rs * rs)
    return -2.0 * A * (1.0 + a1 * rs) * torch.log1p(1.0 / den)


def _fzeta(z):
    return (safepow(1.0 + z, 4.0 / 3.0) + safepow(1.0 - z, 4.0 / 3.0)
            - 2.0) / (2.0 ** (4.0 / 3.0) - 2.0)


_FDD0 = 1.709920934161365  # f''(0)


class LDA_C_PW(BaseXC):
    """Perdew-Wang 1992 correlation."""
    family = 1

    def edens_pol(self, rho_u, rho_d, **kw):
        n = rho_u + rho_d
        rs = _rs(n)
        z = _zeta(rho_u, rho_d)
        ec0 = _pw92_G(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
        ec1 = _pw92_G(rs, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
        mac = _pw92_G(rs, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
        f = _fzeta(z)
        z4 = z ** 4
        ec = ec0 - mac * f / _FDD0 * (1.0 - z4) + (ec1 - ec0) * f * z4
        return n * ec

    def edens_unpol(self, rho, **kw):
        rs = _rs(rho)
        ec0 = _pw92_G(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
        return rho * ec0


def _vwn_eps(rs, A, x0, b, c):
    x = torch.sqrt(rs)
    X = rs + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = np.sqrt(4.0 * c - b * b)
    atanq = torch.atan(Q / (2.0 * x + b))
    return A * (torch.log(rs / X) + 2.0 * b / Q * atanq
                - b * x0 / X0 * (torch.log((x - x0) ** 2 / X)
                                 + 2.0 * (b + 2.0 * x0) / Q * atanq))


class LDA_C_VWN5(BaseXC):
    """VWN formula V (the 'VWN' of libxc)."""
    family = 1
    _PARA = (0.0310907, -0.10498, 3.72744, 12.9352)
    _FERRO = (0.01554535, -0.32500, 7.06042, 18.0578)
    _ALPHA = (-1.0 / (6.0 * np.pi ** 2), -0.0047584, 1.13107, 13.0045)

    def edens_pol(self, rho_u, rho_d, **kw):
        n = rho_u + rho_d
        rs = _rs(n)
        z = _zeta(rho_u, rho_d)
        e0 = _vwn_eps(rs, *self._PARA)
        e1 = _vwn_eps(rs, *self._FERRO)
        ea = _vwn_eps(rs, *self._ALPHA)
        f = _fzeta(z)
        z4 = z ** 4
        ec = e0 + ea * f / _FDD0 * (1.0 - z4) + (e1 - e0) * f * z4
        return n * ec

    def edens_unpol(self, rho, **kw):
        return rho * _vwn_eps(_rs(rho), *self._PARA)


class LDA_C_PZ(BaseXC):
    """Perdew-Zunger 1981 correlation (Ceperley-Alder fit), libxc
    lda_c_pz: parameters of PRB 23, 5048 (1981), Table XII; spin
    interpolation ec = ecU + f(zeta)*(ecP - ecU)."""
    family = 1
    #      gamma     beta1   beta2    A        B       C        D
    _U = (-0.1423, 1.0529, 0.3334, 0.0311, -0.048, 0.0020, -0.0116)
    _P = (-0.0843, 1.3981, 0.2611, 0.01555, -0.0269, 0.0007, -0.0048)

    @staticmethod
    def _eps(rs, p):
        g, b1, b2, A, B, C, D = p
        ln = torch.log(rs)
        lo = A * ln + B + C * rs * ln + D * rs
        hi = g / (1.0 + b1 * torch.sqrt(rs) + b2 * rs)
        return torch.where(rs < 1.0, lo, hi)

    def edens_pol(self, rho_u, rho_d, **kw):
        n = rho_u + rho_d
        rs = _rs(n)
        e0 = self._eps(rs, self._U)
        e1 = self._eps(rs, self._P)
        return n * (e0 + (e1 - e0) * _fzeta(_zeta(rho_u, rho_d)))

    def edens_unpol(self, rho, **kw):
        return rho * self._eps(_rs(rho), self._U)


class LDA_C_VWN3(BaseXC):
    """VWN formula III on the RPA fit (libxc lda_c_vwn_rpa), the
    correlation of Gaussian-convention B3LYP."""
    family = 1
    _PARA = (0.0310907, -0.409286, 13.0720, 42.7198)
    _FERRO = (0.01554535, -0.743294, 20.1231, 101.578)

    def edens_pol(self, rho_u, rho_d, **kw):
        n = rho_u + rho_d
        rs = _rs(n)
        z = _zeta(rho_u, rho_d)
        e0 = _vwn_eps(rs, *self._PARA)
        e1 = _vwn_eps(rs, *self._FERRO)
        return n * (e0 + (e1 - e0) * _fzeta(z))

    def edens_unpol(self, rho, **kw):
        return rho * _vwn_eps(_rs(rho), *self._PARA)


def _erf_attenuation(a):
    """Short-range attenuation factor F(a) of Slater exchange for the
    erf-split Coulomb kernel, a = omega / (2 kF):

      F(a) = 1 - (8a/3)[ sqrt(pi) erf(1/(2a)) + (2a - 4a^3) e^{-1/(4a^2)}
                         - 3a + 4a^3 ]

    The closed form cancels its 4a^3 terms against a result of order a^-2
    and returns garbage beyond a ~ 1e3, so from a = 6 on the asymptotic
    series F = x^2/9 - x^4/60 + x^6/420 - x^8/3240 (x = 1/(2a)) takes over;
    the two agree to about 4e-9 relative at the seam. Both branches are
    evaluated everywhere on clipped inputs, so no lane sees a NaN."""
    sqrt_pi = np.sqrt(np.pi)
    a_s = fclip(a, 1e-12, 6.0)
    a3 = a_s * a_s * a_s
    expf = torch.exp(-1.0 / (4.0 * a_s * a_s))
    f_exact = 1.0 - (8.0 / 3.0) * a_s * (
        sqrt_pi * torch.special.erf(0.5 / a_s)
        + (2.0 * a_s - 4.0 * a3) * expf - 3.0 * a_s + 4.0 * a3)
    a_l = fmax(a, 6.0)
    x2 = 1.0 / (4.0 * a_l * a_l)
    f_series = x2 * (1.0 / 9.0 + x2 * (-1.0 / 60.0 + x2 * (
        1.0 / 420.0 - x2 * (1.0 / 3240.0))))
    return torch.where(a < 6.0, f_exact, f_series)


class LDA_X_ERF(BaseXC):
    """Short-range Slater exchange of the erf-split kernel (libxc
    lda_x_erf): per spin channel e = e_x^LDA(rho_s) F(omega / (2 kF_s)),
    kF_s = (6 pi^2 rho_s)^(1/3). With lr_hf(omega), the complementary
    long-range exact exchange, and a correlation it makes an LC-class
    hybrid. omega -> 0 gives lda_x; omega -> inf removes the exchange."""
    family = 1
    _CX = (3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0)

    def __init__(self, omega: float):
        self.omega = float(omega)

    def _edens_spin(self, rho_s):
        # exchange spin scaling: E[ru, rd] = (E_unpol[2 ru] + E_unpol[2 rd])/2
        kf = (6.0 * np.pi ** 2 * fmax(rho_s, RHO_EPS)) ** (1.0 / 3.0)
        f = _erf_attenuation(self.omega / (2.0 * kf))
        c = self._CX * 2.0 ** (1.0 / 3.0)
        return -c * safepow(rho_s, 4.0 / 3.0, RHO_EPS) * f

    def edens_pol(self, rho_u, rho_d, **kw):
        return self._edens_spin(rho_u) + self._edens_spin(rho_d)

    def edens_unpol(self, rho, **kw):
        kf = (3.0 * np.pi ** 2 * fmax(rho, RHO_EPS)) ** (1.0 / 3.0)
        f = _erf_attenuation(self.omega / (2.0 * kf))
        return -self._CX * safepow(rho, 4.0 / 3.0, RHO_EPS) * f
