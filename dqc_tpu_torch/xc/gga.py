"""GGA functionals in torch: PBE (x, c) and its variants, B88, LYP, OPTX
(counterpart of dqc_tpu/xc/gga.py).

Formulas from: Perdew, Burke, Ernzerhof PRL 77, 3865 (1996); Becke PRA 38,
3098 (1988); Lee, Yang, Parr PRB 37, 785 (1988) in the Miehlich form
(CPL 157, 200 (1989)); Handy & Cohen, Mol. Phys. 99, 403 (2001); the
short-range B88 of the range-separated hybrids by the attenuation of
Iikura, Tsuneda, Yanai & Hirao, JCP 115, 3540 (2001).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.safeops import RHO_EPS, SIG_EPS, fclip, fmax, safepow
from .base import BaseXC
from .lda import LDA_C_PW, _erf_attenuation, _zeta


class GGA_X_PBE(BaseXC):
    family = 2
    _KAPPA = 0.8040
    _MU = 0.2195149727645171

    def _s2(self, rho, sigma):
        # s^2 = sigma / (4 (3pi^2)^{2/3} n^{8/3}); returns (kf, s^2)
        kf = ((3.0 * np.pi ** 2) ** (1.0 / 3.0)
              * safepow(rho, 1.0 / 3.0, RHO_EPS))
        s2 = fmax(sigma, SIG_EPS) / (4.0 * kf * kf * fmax(rho, RHO_EPS) ** 2)
        return kf, s2

    def _enhancement(self, s2):
        return 1.0 + self._KAPPA - self._KAPPA / (1.0 + self._MU * s2
                                                  / self._KAPPA)

    def _e_unpol(self, rho, sigma):
        kf, s2 = self._s2(rho, sigma)
        ex_lda = -3.0 / (4.0 * np.pi) * kf * rho
        return ex_lda * self._enhancement(s2)

    def edens_unpol(self, rho, sigma=None, **kw):
        return self._e_unpol(rho, sigma)

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, **kw):
        # exact spin scaling: Ex[nu,nd] = (Ex[2nu] + Ex[2nd]) / 2
        return 0.5 * (self._e_unpol(2.0 * rho_u, 4.0 * sigma_uu)
                      + self._e_unpol(2.0 * rho_d, 4.0 * sigma_dd))


class GGA_C_PBE(BaseXC):
    family = 2
    _BETA = 0.06672455060314922
    _GAMMA = (1.0 - np.log(2.0)) / np.pi ** 2

    def __init__(self):
        self._pw = LDA_C_PW()

    def _h(self, n, sigma, z, ec_lda_per_n):
        phi = 0.5 * (safepow(1.0 + z, 2.0 / 3.0) + safepow(1.0 - z, 2.0 / 3.0))
        kf = (3.0 * np.pi ** 2 * fmax(n, RHO_EPS)) ** (1.0 / 3.0)
        ks = torch.sqrt(4.0 * kf / np.pi)
        t2 = fmax(sigma, SIG_EPS) / (4.0 * phi * phi * ks * ks
                                     * fmax(n, RHO_EPS) ** 2)
        phi3 = phi ** 3
        bg = self._BETA / self._GAMMA
        expo = torch.exp(-ec_lda_per_n / (self._GAMMA * phi3))
        A = bg / fmax(expo - 1.0, 1e-30)
        at2 = A * t2
        num = 1.0 + at2
        den = 1.0 + at2 + at2 * at2
        return self._GAMMA * phi3 * torch.log1p(bg * t2 * num / den)

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, **kw):
        n = rho_u + rho_d
        z = _zeta(rho_u, rho_d)
        sigma = sigma_uu + 2.0 * sigma_ud + sigma_dd
        ec_lda = self._pw.edens_pol(rho_u, rho_d) / fmax(n, RHO_EPS)
        return n * (ec_lda + self._h(n, sigma, z, ec_lda))

    def edens_unpol(self, rho, sigma=None, **kw):
        ec_lda = self._pw.edens_unpol(rho) / fmax(rho, RHO_EPS)
        z = torch.zeros_like(rho)
        return rho * (ec_lda + self._h(rho, sigma, z, ec_lda))


class GGA_X_B88(BaseXC):
    family = 2
    _BETA = 0.0042

    def _e_spin(self, ns, sigma_ss):
        # per spin: e_s = ex_lda(ns) - beta ns^{4/3} x^2 / (1 + 6 beta x asinh x)
        n43 = safepow(ns, 4.0 / 3.0, RHO_EPS)
        x = torch.sqrt(fmax(sigma_ss, SIG_EPS)) / n43
        cx = (3.0 / 2.0) * (3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
        e_lda = -cx * n43
        corr = -self._BETA * n43 * x * x / (1.0 + 6.0 * self._BETA * x
                                            * torch.asinh(x))
        return e_lda + corr

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, **kw):
        return self._e_spin(rho_u, sigma_uu) + self._e_spin(rho_d, sigma_dd)

    def edens_unpol(self, rho, sigma=None, **kw):
        return 2.0 * self._e_spin(0.5 * rho, 0.25 * sigma)


class GGA_X_ITYH_B88(GGA_X_B88):
    """Short-range (erfc-complement) B88 exchange by the ITYH attenuation
    (JCP 115, 3540 (2001), eqs 4-8; libxc gga_x_ityh), the DFT-exchange
    part of CAM-B3LYP and LC-BLYP.

    Per spin: E_x^SR = sum_s int e_s(n_s, sigma_ss) F(a_s), with the GGA
    exchange written e_s = -(1/2) n_s^{4/3} K_s, a_s = w sqrt(K_s) /
    (6 sqrt(pi) n_s^{1/3}), and F the attenuation of lda._erf_attenuation
    (whose large-a series keeps omega -> inf at zero, not at full B88),
    clipped to [0, 1]."""

    def __init__(self, omega: float):
        self.omega = float(omega)

    @staticmethod
    def _att(a):
        return fclip(_erf_attenuation(fmax(a, 1e-10)), 0.0, 1.0)

    def _e_spin(self, ns, sigma_ss):
        e_full = GGA_X_B88._e_spin(self, ns, sigma_ss)
        n43 = safepow(ns, 4.0 / 3.0, RHO_EPS)
        n13 = safepow(ns, 1.0 / 3.0, RHO_EPS)
        k = fmax(-2.0 * e_full / n43, 1e-15)
        a = self.omega * torch.sqrt(k) / (6.0 * np.sqrt(np.pi) * n13)
        return e_full * self._att(a)


class GGA_C_LYP(BaseXC):
    family = 2
    _A, _B, _C, _D = 0.04918, 0.132, 0.2533, 0.349
    _CF = 0.3 * (3.0 * np.pi ** 2) ** (2.0 / 3.0)

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, **kw):
        a, b, c, d = self._A, self._B, self._C, self._D
        n = fmax(rho_u + rho_d, RHO_EPS)
        nu = fmax(rho_u, 0.0)
        nd = fmax(rho_d, 0.0)
        icbrt = 1.0 / safepow(n, 1.0 / 3.0)
        denom = 1.0 + d * icbrt
        # log space: n^{-11/3} alone overflows for tiny n, while the
        # combined exponent stays moderate (or -inf)
        log_omega = (-c * icbrt - (11.0 / 3.0) * torch.log(n)
                     - torch.log(denom))
        omega = torch.exp(log_omega)
        delta = c * icbrt + d * icbrt / denom
        sigma = sigma_uu + 2.0 * sigma_ud + sigma_dd
        nund = nu * nd
        term1 = -4.0 * a * nund / (n * denom)
        t_cf = 2.0 ** (11.0 / 3.0) * self._CF * (safepow(nu, 8.0 / 3.0)
                                                 + safepow(nd, 8.0 / 3.0))
        t_ab = (47.0 / 18.0 - 7.0 * delta / 18.0) * sigma \
            - (5.0 / 2.0 - delta / 18.0) * (sigma_uu + sigma_dd) \
            - (delta - 11.0) / 9.0 * (nu * sigma_uu + nd * sigma_dd) / n
        t_rest = (-2.0 / 3.0 * n * n * sigma
                  + (2.0 / 3.0 * n * n - nu * nu) * sigma_dd
                  + (2.0 / 3.0 * n * n - nd * nd) * sigma_uu)
        return term1 - a * b * omega * (nund * (t_cf + t_ab) + t_rest)


class GGA_X_PBE_SOL(GGA_X_PBE):
    """PBEsol exchange: mu = 10/81 (Perdew et al. PRL 100, 136406 (2008))."""
    _MU = 10.0 / 81.0


class GGA_X_REVPBE(GGA_X_PBE):
    """revPBE exchange: kappa = 1.245 (Zhang & Yang PRL 80, 890 (1998))."""
    _KAPPA = 1.245


class GGA_X_RPBE(GGA_X_PBE):
    """RPBE exchange: F(s) = 1 + kappa*(1 - exp(-mu s^2 / kappa))
    (Hammer, Hansen, Norskov PRB 59, 7413 (1999))."""

    def _enhancement(self, s2):
        return 1.0 + self._KAPPA * (1.0 - torch.exp(-self._MU * s2
                                                    / self._KAPPA))


class GGA_C_PBE_SOL(GGA_C_PBE):
    """PBEsol correlation: beta = 0.046 (PRL 100, 136406 (2008))."""
    _BETA = 0.046


class GGA_X_OPTX(BaseXC):
    """OPTX exchange (Handy & Cohen, Mol. Phys. 99, 403 (2001)), libxc
    gga_x_optx, the exchange half of OLYP. Per spin:
    e_s = -ns^{4/3} [a1*Cx + a2*(g*x^2/(1+g*x^2))^2], x = |grad ns|/ns^{4/3}.
    """
    family = 2
    _A1 = 1.05151
    _A2 = 1.43169
    _GAM = 0.006

    def _e_spin(self, ns, sigma_ss):
        n43 = safepow(ns, 4.0 / 3.0, RHO_EPS)
        x2 = fmax(sigma_ss, SIG_EPS) / (n43 * n43)
        cx = (3.0 / 2.0) * (3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
        u = self._GAM * x2 / (1.0 + self._GAM * x2)
        return -n43 * (self._A1 * cx + self._A2 * u * u)

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, **kw):
        return self._e_spin(rho_u, sigma_uu) + self._e_spin(rho_d, sigma_dd)

    def edens_unpol(self, rho, sigma=None, **kw):
        return 2.0 * self._e_spin(0.5 * rho, 0.25 * sigma)
