"""Meta-GGA functionals in torch: SCAN (Sun, Ruzsinszky, Perdew, PRL 115,
036402 (2015)) and TPSS (Tao, Perdew, Staroverov, Scuseria, PRL 91, 146401
(2003); explicit forms in JCP 120, 6898 (2004)). Counterpart of
dqc_tpu/xc/mgga.py.

The interpolation functions are written with a branch-safe where (both
branches evaluated on clipped arguments), so that no derivative order sees
a NaN at alpha = 1, at tau -> tau_W or at a screened point; the forms are
the JAX package's, kept as they are for that reason.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.safeops import RHO_EPS, fclip, fmax, safepow
from .base import BaseXC
from .gga import GGA_C_PBE
from .lda import _fzeta, _pw92_G, _rs, _zeta

_TAU_EPS = 1e-30


def _alpha_iso(rho, sigma, tau, ds=1.0):
    """alpha = (tau - tau_W) / tau_unif, regularized."""
    tau_w = fmax(sigma, 0.0) / (8.0 * fmax(rho, RHO_EPS))
    tau_unif = (0.3 * (3.0 * np.pi ** 2) ** (2.0 / 3.0)
                * safepow(rho, 5.0 / 3.0, RHO_EPS) * ds)
    return (tau - tau_w) / fmax(tau_unif, _TAU_EPS)


def _interp(alpha, c1, c2, d):
    """SCAN's f(alpha): exp(-c1 a/(1-a)) below 1, -d exp(c2/(1-a)) above."""
    a_lo = fclip(alpha, 0.0, 1.0 - 1e-12)
    a_hi = fmax(alpha, 1.0 + 1e-12)
    f_lo = torch.exp(-c1 * a_lo / (1.0 - a_lo))
    f_hi = -d * torch.exp(c2 / (1.0 - a_hi))
    return torch.where(alpha < 1.0, f_lo, f_hi)


def _interp_x(alpha):
    return _interp(alpha, 0.667, 0.8, 1.24)


def _interp_c(alpha):
    return _interp(alpha, 0.64, 1.5, 0.7)


class MGGA_X_SCAN(BaseXC):
    family = 4
    _K1 = 0.065
    _MU = 10.0 / 81.0

    def _e_unpol(self, rho, sigma, tau):
        n = fmax(rho, RHO_EPS)
        kf = (3.0 * np.pi ** 2) ** (1.0 / 3.0) * n ** (1.0 / 3.0)
        s2 = fmax(sigma, 0.0) / (4.0 * kf * kf * n * n)
        s = torch.sqrt(fmax(s2, 1e-40))
        alpha = _alpha_iso(n, sigma, tau)
        mu, k1 = self._MU, self._K1
        b2 = np.sqrt(5913.0 / 405000.0)
        b1 = (511.0 / 13500.0) / (2.0 * b2)
        b3 = 0.5
        b4 = mu * mu / k1 - 1606.0 / 18225.0 - b1 * b1
        one_m_a = 1.0 - alpha
        x = (mu * s2 * (1.0 + (b4 * s2 / mu) * torch.exp(-abs(b4) * s2 / mu))
             + (b1 * s2 + b2 * one_m_a * torch.exp(-b3 * one_m_a ** 2)) ** 2)
        h1x = 1.0 + k1 - k1 / (1.0 + x / k1)
        h0x = 1.174
        a1 = 4.9479
        gx = 1.0 - torch.exp(-a1 / torch.sqrt(fmax(s, 1e-20)))
        fx = _interp_x(alpha)
        Fx = (h1x + fx * (h0x - h1x)) * gx
        ex_lda = -3.0 / (4.0 * np.pi) * kf * n
        return ex_lda * Fx

    def edens_unpol(self, rho, sigma=None, lapl=None, tau=None):
        return self._e_unpol(rho, sigma, tau)

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, lapl_u=None, lapl_d=None,
                  tau_u=None, tau_d=None):
        return 0.5 * (self._e_unpol(2 * rho_u, 4 * sigma_uu, 2 * tau_u)
                      + self._e_unpol(2 * rho_d, 4 * sigma_dd, 2 * tau_d))


class MGGA_C_SCAN(BaseXC):
    family = 4
    _B1C, _B2C, _B3C = 0.0285764, 0.0889, 0.125541
    _GAMMA = 0.031090690869654895
    _CHI = 0.12802585262625815

    def _ec_pw_parts(self, rs, z):
        ec0 = _pw92_G(rs, 0.0310907, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
        ec1 = _pw92_G(rs, 0.01554535, 0.20548, 14.1189, 6.1977, 3.3662,
                      0.62517)
        mac = _pw92_G(rs, 0.0168869, 0.11125, 10.357, 3.6231, 0.88026,
                      0.49671)
        f = _fzeta(z)
        z4 = z ** 4
        fdd0 = 1.709920934161365
        return ec0 - mac * f / fdd0 * (1.0 - z4) + (ec1 - ec0) * f * z4

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, lapl_u=None, lapl_d=None,
                  tau_u=None, tau_d=None):
        n = fmax(rho_u + rho_d, RHO_EPS)
        z = fclip(_zeta(rho_u, rho_d), -1.0 + 1e-12, 1.0 - 1e-12)
        sigma = sigma_uu + 2.0 * sigma_ud + sigma_dd
        tau = tau_u + tau_d
        rs = _rs(n)
        phi = 0.5 * (safepow(1.0 + z, 2.0 / 3.0) + safepow(1.0 - z, 2.0 / 3.0))
        ds = 0.5 * (safepow(1.0 + z, 5.0 / 3.0) + safepow(1.0 - z, 5.0 / 3.0))
        alpha = _alpha_iso(n, sigma, tau, ds=ds)
        kf = (3.0 * np.pi ** 2) ** (1.0 / 3.0) * n ** (1.0 / 3.0)
        s2 = fmax(sigma, 0.0) / (4.0 * kf * kf * n * n)
        # ec1: PW92 + H1
        ec_pw = self._ec_pw_parts(rs, z)
        gam = self._GAMMA
        phi3 = phi ** 3
        t2 = (3.0 * np.pi ** 2 / 16.0) ** (2.0 / 3.0) * s2 / (phi * phi * rs)
        w1 = torch.expm1(-ec_pw / (gam * phi3))
        beta = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs)
        A = beta / (gam * fmax(w1, 1e-30))
        g_at2 = (1.0 + 4.0 * A * t2) ** (-0.25)
        H1 = gam * phi3 * torch.log1p(w1 * (1.0 - g_at2))
        ec1 = ec_pw + H1
        # ec0: LDA0 + H0
        b1c, b2c, b3c = self._B1C, self._B2C, self._B3C
        sqrs = torch.sqrt(rs)
        ec_lda0 = -b1c / (1.0 + b2c * sqrs + b3c * rs)
        w0 = torch.expm1(-ec_lda0 / b1c)
        ginf = (1.0 + 4.0 * self._CHI * s2) ** (-0.25)
        H0 = b1c * torch.log1p(w0 * (1.0 - ginf))
        dx_z = 0.5 * (safepow(1.0 + z, 4.0 / 3.0) + safepow(1.0 - z, 4.0 / 3.0))
        Gc = (1.0 - 2.3631 * (dx_z - 1.0)) * (1.0 - z ** 12)
        ec0 = (ec_lda0 + H0) * Gc
        fc = _interp_c(alpha)
        ec = ec1 + fc * (ec0 - ec1)
        return n * ec

    def edens_unpol(self, rho, sigma=None, lapl=None, tau=None):
        h = 0.5 * rho
        q = 0.25 * sigma
        return self.edens_pol(h, h, q, q, q, tau_u=0.5 * tau, tau_d=0.5 * tau)


class MGGA_X_TPSS(BaseXC):
    family = 4
    _KAPPA = 0.804
    _MU = 0.21951
    _B = 0.40
    _C = 1.59096
    _E = 1.537

    def _e_unpol(self, rho, sigma, tau):
        n = fmax(rho, RHO_EPS)
        sig = fmax(sigma, 0.0)
        kf2 = (3.0 * np.pi ** 2) ** (2.0 / 3.0) * safepow(n, 2.0 / 3.0)
        p = sig / (4.0 * kf2 * n * n)
        tau_w = sig / (8.0 * n)
        t = fmax(tau, _TAU_EPS)
        z = fclip(tau_w / t, 0.0, 1.0)
        alpha = fmax(_alpha_iso(n, sig, t), 0.0)
        b = self._B
        qb = (0.45 * (alpha - 1.0)
              / torch.sqrt(1.0 + b * alpha * (alpha - 1.0))
              + 2.0 * p / 3.0)
        kappa, mu, c, e = self._KAPPA, self._MU, self._C, self._E
        z2 = z * z
        tz2 = (0.6 * z) ** 2          # (3z/5)^2
        sq = torch.sqrt(0.5 * tz2 ** 2 + 0.5 * p * p)
        x = ((10.0 / 81.0 + c * z2 / (1.0 + z2) ** 2) * p
             + 146.0 / 2025.0 * qb * qb
             - 73.0 / 405.0 * qb * sq
             + (10.0 / 81.0) ** 2 * p * p / kappa
             + 2.0 * np.sqrt(e) * (10.0 / 81.0) * tz2
             + e * mu * p ** 3)
        x = x / (1.0 + np.sqrt(e) * p) ** 2
        fx = 1.0 + kappa - kappa / (1.0 + x / kappa)
        ex_lda = (-(3.0 / (4.0 * np.pi)) * (3.0 * np.pi ** 2) ** (1.0 / 3.0)
                  * safepow(n, 4.0 / 3.0))
        return ex_lda * fx

    def edens_unpol(self, rho, sigma=None, lapl=None, tau=None):
        return self._e_unpol(rho, sigma, tau)

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, lapl_u=None, lapl_d=None,
                  tau_u=None, tau_d=None):
        return 0.5 * (self._e_unpol(2 * rho_u, 4 * sigma_uu, 2 * tau_u)
                      + self._e_unpol(2 * rho_d, 4 * sigma_dd, 2 * tau_d))


class MGGA_C_TPSS(BaseXC):
    """TPSS correlation: revPKZB with the self-interaction-free z^3
    correction (JCP 120, 6898 (2004) eqs. 11-14)."""
    family = 4
    _D = 2.8

    def __init__(self):
        self._pbe = GGA_C_PBE()

    def _ec_pbe_per_n(self, rho_u, rho_d, suu, sud, sdd):
        n = fmax(rho_u + rho_d, RHO_EPS)
        return self._pbe.edens_pol(rho_u, rho_d, suu, sud, sdd) / n

    def edens_pol(self, rho_u, rho_d, sigma_uu=None, sigma_ud=None,
                  sigma_dd=None, lapl_u=None, lapl_d=None,
                  tau_u=None, tau_d=None):
        nu = fmax(rho_u, 0.0)
        nd = fmax(rho_d, 0.0)
        n = fmax(nu + nd, RHO_EPS)
        suu = fmax(sigma_uu, 0.0)
        sdd = fmax(sigma_dd, 0.0)
        sigma = fmax(suu + 2.0 * sigma_ud + sdd, 0.0)
        tau = fmax(tau_u + tau_d, _TAU_EPS)
        tau_w = sigma / (8.0 * n)
        z = fclip(tau_w / tau, 0.0, 1.0)
        zeta = fclip(_zeta(nu, nd), -1.0 + 1e-12, 1.0 - 1e-12)
        # xi = |grad zeta| / (2 (3 pi^2 n)^{1/3});
        # |grad zeta|^2 = 4 (nd^2 suu - 2 nu nd sud + nu^2 sdd) / n^4
        gz2 = 4.0 * fmax(
            nd * nd * suu - 2.0 * nu * nd * sigma_ud + nu * nu * sdd, 0.0) \
            / n ** 4
        xi2 = gz2 / (4.0 * (3.0 * np.pi ** 2 * n) ** (2.0 / 3.0))
        cz = (0.53 + 0.87 * zeta ** 2 + 0.50 * zeta ** 4
              + 2.26 * zeta ** 6)
        den = (1.0 + xi2 * 0.5 * (safepow(1.0 + zeta, -4.0 / 3.0)
                                  + safepow(1.0 - zeta, -4.0 / 3.0))) ** 4
        C = cz / den
        ec_pbe = self._ec_pbe_per_n(nu, nd, suu, sigma_ud, sdd)
        tiny = torch.full_like(nu, RHO_EPS)
        zero = torch.zeros_like(nu)
        ec_u = self._ec_pbe_per_n(nu, tiny, suu, zero, zero)
        ec_d = self._ec_pbe_per_n(nd, tiny, sdd, zero, zero)
        ec_u = torch.maximum(ec_u, ec_pbe)
        ec_d = torch.maximum(ec_d, ec_pbe)
        z2 = z * z
        ec_rev = (ec_pbe * (1.0 + C * z2)
                  - (1.0 + C) * z2 * (nu / n * ec_u + nd / n * ec_d))
        ec = ec_rev * (1.0 + self._D * ec_rev * z2 * z)
        return n * ec

    def edens_unpol(self, rho, sigma=None, lapl=None, tau=None):
        h = 0.5 * rho
        q = 0.25 * sigma
        return self.edens_pol(h, h, q, q, q, tau_u=0.5 * tau, tau_d=0.5 * tau)
