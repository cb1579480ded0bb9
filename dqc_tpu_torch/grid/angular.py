"""Angular quadrature on the unit sphere (counterpart of
dqc_tpu/grid/angular.py): the Lebedev-Laikov tables up to degree 131, and
a generated product rule (Gauss-Legendre in cos(theta) x equispaced phi,
about (L+1)^2/2 points) beyond them. The JAX package's
DQC_TPU_ANGULAR=product switch is not carried over, so the rule family is
always the Lebedev one ("leb" in a cache signature).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .lebedev import lebedev_by_degree


@lru_cache(maxsize=None)
def product_angular_grid(degree: int):
    """Quadrature exact for spherical harmonics up to `degree`.

    Returns (points (n,3) unit vectors, weights (n,) summing to 4 pi)."""
    ntheta = degree // 2 + 1
    nphi = degree + 1
    ct, wt = np.polynomial.legendre.leggauss(ntheta)   # cos(theta) nodes
    phi = 2.0 * np.pi * np.arange(nphi) / nphi
    wphi = 2.0 * np.pi / nphi
    st = np.sqrt(1.0 - ct ** 2)
    x = (st[:, None] * np.cos(phi)[None, :]).ravel()
    y = (st[:, None] * np.sin(phi)[None, :]).ravel()
    z = np.broadcast_to(ct[:, None], (ntheta, nphi)).ravel()
    w = np.broadcast_to((wt * wphi)[:, None], (ntheta, nphi)).ravel()
    pts = np.stack([x, y, z], axis=1)
    return pts, w.copy()


def angular_rule(degree: int):
    """The Lebedev rule of at least `degree`, or the product rule beyond
    degree 131. Returns (points (n, 3), weights (n,) summing to 4 pi)."""
    if degree <= 131:
        return lebedev_by_degree(int(degree))
    return product_angular_grid(int(degree))


def angular_rule_tag() -> str:
    """The angular rule family, a component of Mol.cache_signature: "leb"
    (the JAX package's default; its product-rule switch is not ported)."""
    return "leb"


def angular_grid_by_precision(prec: int):
    """Grid exact to spherical-harmonic degree >= prec."""
    return angular_rule(int(prec))
