"""Lebedev-Laikov angular quadrature on the unit sphere (counterpart of
dqc_tpu/grid/lebedev.py).

The point sets are the published Lebedev-Laikov tables (Lebedev & Laikov,
Dokl. Math. 59, 477 (1999)); this package keeps its own copy under
datasets/lebedevquad/. A rule of degree L integrates spherical harmonics
up to L exactly with about (L+1)^2/3 points.

File format (per row): phi [deg], theta [deg], weight (weights sum to 1);
returned as unit vectors and weights summing to 4 pi.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

LEBEDEV_PRECISIONS = [3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29,
                      31, 35, 41, 47, 53, 59, 65, 71, 77, 83, 89, 95, 101,
                      107, 113, 119, 125, 131]

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "datasets", "lebedevquad")


@lru_cache(maxsize=None)
def lebedev_grid(prec: int):
    """Lebedev rule of (odd) precision `prec` in [3, 131].

    Returns (points (n, 3) unit vectors, weights (n,) summing to 4 pi)."""
    if prec not in LEBEDEV_PRECISIONS:
        raise ValueError(f"no Lebedev table of precision {prec}; "
                         f"available: {LEBEDEV_PRECISIONS}")
    data = np.loadtxt(os.path.join(_DATA_DIR, "lebedev_%03d.txt" % prec))
    phi = np.deg2rad(data[:, 0])
    theta = np.deg2rad(data[:, 1])
    w = data[:, 2] * (4.0 * np.pi)
    st = np.sin(theta)
    pts = np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)],
                   axis=1)
    return pts, w


def lebedev_by_degree(degree: int):
    """Smallest Lebedev rule exact to >= `degree` (<= 131)."""
    for p in LEBEDEV_PRECISIONS:
        if p >= degree:
            return lebedev_grid(p)
    raise ValueError(f"no Lebedev table of degree >= {degree} (max 131)")
