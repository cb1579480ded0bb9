"""Radial quadratures and coordinate transforms (counterpart of
dqc_tpu/grid/radial.py).

Gauss-Chebyshev (2nd kind), the transformed Chebyshev rule of
Perez-Jorda & San-Fabian and a uniform rule on (-1, 1), mapped to
r in (0, inf) by the DE2, LogM3 or Treutler M4 transforms. Host-side
numpy: grid construction has data-dependent sizes; only the flat arrays
it produces go to the device.
"""
from __future__ import annotations

import numpy as np


def chebyshev2_quadrature(n: int):
    """Gauss-Chebyshev quadrature of the second kind on (-1, 1) adapted for
    integrating f(x) directly (weight function divided out)."""
    i = np.arange(1, n + 1)
    theta = i * np.pi / (n + 1)
    x = np.cos(theta)
    w = np.pi / (n + 1) * np.sin(theta) ** 2
    # divide out the Chebyshev weight sqrt(1-x^2)
    w = w / np.sqrt(1.0 - x ** 2)
    return x[::-1].copy(), w[::-1].copy()


def chebyshev_quadrature(n: int):
    """Transformed Gauss-Chebyshev rule of Perez-Jorda & San-Fabian,
    eq (9)-(10) of doi:10.1063/1.475719: an open rule on (-1, 1) whose
    weights vanish like sin^4 at the endpoints."""
    np1 = n + 1.0
    i = np.arange(n, 0, -1)
    t = i * np.pi / np1
    s = np.sin(t)
    c = np.cos(t)
    x = (np1 - 2.0 * i) / np1 + 2.0 / np.pi * (1.0 + 2.0 / 3.0 * s * s) * c * s
    w = 16.0 / (3.0 * np1) * s ** 4
    return x, w


def uniform_quadrature(n: int):
    x = np.linspace(-1.0, 1.0, n + 2)[1:-1]
    w = np.full(n, 2.0 / (n + 1))
    return x, w


class DE2Transformation:
    """Double-exponential x->r map, eq (31) of doi:10.1007/s00214-011-0985-x:
    r = exp(alpha*t - exp(-t)) with t affinely mapped from x in [-1, 1] to
    [xmin, xmax], xmin = -ln(-ln rmin), xmax = ln(rmax)/alpha. The Dasgupta
    sg2/sg3 slice indices (grid/factory.py) assume this distribution."""

    def __init__(self, alpha: float = 1.0, rmin: float = 1e-7,
                 rmax: float = 20.0):
        assert rmin < 1.0
        self.alpha = alpha
        self.xmin = -np.log(-np.log(rmin))
        self.xmax = np.log(rmax) / alpha
        self.tm = 0.5 * (self.xmax - self.xmin)
        self.tb = 0.5 * (self.xmax + self.xmin)

    def r_and_drdx(self, x):
        t = self.tm * x + self.tb
        r = np.exp(self.alpha * t - np.exp(-t))
        drdx = r * (self.alpha + np.exp(-t)) * self.tm
        return r, drdx


class LogM3Transformation:
    """r = -zeta/log2 * log((1-x)/2)  (Mura-Knowles M3)."""

    def __init__(self, zeta: float = 1.0):
        self.zeta = zeta

    def r_and_drdx(self, x):
        r = -self.zeta / np.log(2.0) * np.log((1.0 - x) / 2.0)
        drdx = self.zeta / np.log(2.0) / (1.0 - x)
        return r, drdx


class TreutlerM4Transformation:
    """Treutler-Ahlrichs M4 map: r = xi/ln2 * (1+x)^a * ln(2/(1-x)),
    a = 0.6."""

    def __init__(self, xi: float = 1.0, a: float = 0.6):
        self.xi = xi
        self.a = a

    def r_and_drdx(self, x):
        ln2 = np.log(2.0)
        opx = 1.0 + x
        lnt = np.log(2.0 / (1.0 - x))
        r = self.xi / ln2 * opx ** self.a * lnt
        drdx = self.xi / ln2 * (self.a * opx ** (self.a - 1.0) * lnt
                                + opx ** self.a / (1.0 - x))
        return r, drdx


_QUADRATURES = {"chebyshev2": chebyshev2_quadrature,
                "chebyshev": chebyshev_quadrature,
                "uniform": uniform_quadrature}


def radial_grid(n: int, transform, quadrature: str = "chebyshev2"):
    """Returns (r, w) with w including the r^2 dr/dx factor (not the 4 pi:
    the angular rule integrates to 4 pi)."""
    if quadrature not in _QUADRATURES:
        raise ValueError(quadrature)
    x, wx = _QUADRATURES[quadrature](n)
    r, drdx = transform.r_and_drdx(x)
    w = wx * drdx * r ** 2
    return r, w
