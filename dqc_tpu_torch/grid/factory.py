"""Molecular quadrature grid factory (counterpart of
dqc_tpu/grid/factory.py).

Named grids "sg2"/"sg3" (Dasgupta scheme: uniform x DE2 radial and
per-slice Lebedev truncation tables) and integer levels 0-9 (per-element
Treutler-Ahlrichs M4 radial and NWChem-style pruning). The factory runs on
the host (data-dependent shapes) and emits a GridSpec of flat numpy
arrays; point positions and Becke weights are recomputed on the device by
xc/integrate.setup_grid_theta. For a periodic cell the grid is wrapped
into the cell (PBCGridSpec, pbc_wrap_grid); get_predefined_grid(...,
pbc=True) builds the atomic grids it wraps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..utils.periodictable import get_bragg_radius, get_expected_radius
from .angular import angular_rule, product_angular_grid
from .radial import (DE2Transformation, TreutlerM4Transformation,
                     radial_grid)

# Treutler-Ahlrichs xi parameters (Treutler & Ahlrichs, JCP 102, 346 (1995)).
_TREUTLER_XI = {
    1: 0.8, 2: 0.9, 3: 1.8, 4: 1.4, 5: 1.3, 6: 1.1, 7: 0.9, 8: 0.9, 9: 0.9,
    10: 0.9, 11: 1.4, 12: 1.3, 13: 1.3, 14: 1.2, 15: 1.1, 16: 1.0, 17: 1.0,
    18: 1.0, 19: 1.5, 20: 1.4, 21: 1.3, 22: 1.2, 23: 1.2, 24: 1.2, 25: 1.2,
    26: 1.2, 27: 1.2, 28: 1.1, 29: 1.1, 30: 1.1, 31: 1.1, 32: 1.0, 33: 0.9,
    34: 0.9, 35: 0.9, 36: 0.9,
}

# (nr_base, angular degree) per level; nr grows with period.
_LEVELS = [(30, 9), (40, 11), (60, 17), (75, 23), (90, 29), (99, 35),
           (120, 41), (150, 47), (200, 53), (250, 59)]
_NAMED = {"sg2": (75, 29), "sg3": (99, 41)}

# --- Dasgupta sg2/sg3 grids (Dasgupta & Herbert, J. Comput. Chem. 38,
# 869 (2017), doi:10.1002/jcc.24761): per-Z DE2 radial alphas, and per-Z
# (radial-slice boundaries, angular precision per slice).
_SG2_DE2_ALPHAS = {1: 2.6, 3: 3.2, 4: 2.4, 5: 2.4, 6: 2.2, 7: 2.2, 8: 2.2,
                   9: 2.2, 11: 3.2, 12: 2.4, 13: 2.5, 14: 2.3, 15: 2.5,
                   16: 2.5, 17: 2.5}
_SG3_DE2_ALPHAS = {1: 2.7, 3: 3.0, 4: 2.4, 5: 2.4, 6: 2.4, 7: 2.4, 8: 2.6,
                   9: 2.1, 11: 3.2, 12: 2.6, 13: 2.6, 14: 2.8, 15: 2.4,
                   16: 2.4, 17: 2.6}
_DASGUPTA_IDX = {
    75: {1: [0, 35, 47, 63, 70, 75], 3: [0, 35, 47, 64, 71, 75],
         4: [0, 35, 47, 64, 71, 75], 5: [0, 35, 47, 64, 71, 75],
         6: [0, 35, 47, 64, 71, 75], 7: [0, 35, 47, 64, 71, 75],
         8: [0, 30, 44, 62, 70, 75], 9: [0, 26, 42, 61, 69, 75],
         11: [0, 35, 47, 64, 71, 75], 12: [0, 35, 47, 64, 71, 75],
         13: [0, 32, 47, 64, 71, 75], 14: [0, 32, 47, 64, 71, 75],
         15: [0, 30, 44, 61, 68, 75], 16: [0, 30, 44, 61, 68, 75],
         17: [0, 26, 42, 61, 69, 75]},
    99: {1: [0, 45, 61, 82, 92, 99], 3: [0, 46, 62, 84, 93, 99],
         4: [0, 42, 48, 62, 84, 87, 93, 99], 5: [0, 42, 48, 62, 84, 93, 99],
         6: [0, 46, 62, 84, 85, 87, 93, 99], 7: [0, 40, 58, 82, 93, 99],
         8: [0, 40, 54, 56, 58, 82, 83, 84, 92, 99],
         9: [0, 35, 52, 56, 81, 83, 91, 99], 11: [0, 46, 62, 84, 93, 99],
         12: [0, 48, 63, 83, 90, 99], 13: [0, 42, 48, 62, 84, 87, 93, 99],
         14: [0, 42, 48, 62, 84, 93, 99],
         15: [0, 35, 36, 54, 58, 83, 85, 93, 99],
         16: [0, 35, 36, 54, 58, 83, 85, 93, 99],
         17: [0, 35, 52, 56, 81, 83, 91, 99]},
}
_DASGUPTA_PRECS = {
    75: {1: [3, 17, 29, 15, 7], 3: [3, 17, 29, 15, 11],
         4: [3, 17, 29, 15, 11], 5: [3, 17, 29, 19, 7],
         6: [3, 17, 29, 19, 7], 7: [3, 17, 29, 15, 7],
         8: [3, 17, 29, 19, 11], 9: [3, 17, 29, 17, 11],
         11: [3, 17, 29, 15, 11], 12: [3, 17, 29, 15, 11],
         13: [3, 17, 29, 19, 11], 14: [3, 17, 29, 19, 11],
         15: [3, 17, 29, 19, 9], 16: [3, 17, 29, 19, 9],
         17: [3, 17, 29, 17, 11]},
    99: {1: [3, 17, 41, 23, 11], 3: [3, 17, 41, 19, 11],
         4: [3, 15, 17, 41, 23, 19, 11], 5: [3, 15, 17, 41, 23, 11],
         6: [3, 19, 41, 29, 23, 19, 15], 7: [3, 17, 41, 19, 11],
         8: [3, 17, 23, 29, 41, 29, 23, 19, 11],
         9: [3, 17, 23, 41, 23, 17, 11], 11: [3, 17, 41, 19, 11],
         12: [3, 17, 41, 19, 11], 13: [3, 15, 17, 41, 23, 19, 11],
         14: [3, 15, 17, 41, 23, 11], 15: [3, 15, 17, 23, 41, 23, 19, 11],
         16: [3, 15, 17, 23, 41, 23, 19, 11], 17: [3, 17, 23, 41, 23, 17, 11]},
}


def _period(z: int) -> int:
    if z <= 2:
        return 1
    if z <= 10:
        return 2
    if z <= 18:
        return 3
    return 4


@dataclass
class GridSpec:
    """Flat per-point arrays (host numpy; static for a given molecule)."""
    ratom: np.ndarray      # (ng,) radial distance from owning atom
    dirs: np.ndarray       # (ng, 3) unit direction from owning atom
    w0: np.ndarray         # (ng,) radial x angular weight (incl. r^2 dr)
    atom_idx: np.ndarray   # (ng,) owning atom
    atom_radii: np.ndarray  # (natm,) Bragg radii for Becke adjustment

    @property
    def ngrid(self) -> int:
        return len(self.ratom)


def _pruned_degree(r_over_R: float, degree: int) -> int:
    """NWChem-style radial pruning of the angular degree."""
    if r_over_R < 0.1:
        return min(9, degree)
    if r_over_R < 0.35:
        return min(17, degree)
    if r_over_R < 0.8:
        return min(29, degree)
    return degree


@dataclass
class PBCGridSpec:
    """Cell-wrapped periodic Becke grid (host numpy; fixed when the cell is
    built): every atomic-grid point is translated back into the unit cell;
    the translated copies of its parent atom become "virtual atoms", and the
    Becke partition runs over them. The shifts and the point-to-virtual-atom
    map are frozen from the construction geometry; the point coordinates and
    the weights are recomputed from atompos on the device
    (scf/pbc.setup_pbc_grid_theta), so the quadrature moves with the atoms."""
    ratom: np.ndarray       # (ng,) radial distance from the owning real atom
    dirs: np.ndarray        # (ng, 3)
    w0: np.ndarray          # (ng,)
    atom_idx: np.ndarray    # (ng,) owning real atom (for point coordinates)
    shift: np.ndarray       # (ng, 3) lattice translation into the cell
    vatom_idx: np.ndarray   # (ng,) owning virtual atom (for Becke weights)
    vowner: np.ndarray      # (nv,) real atom behind each virtual atom
    vshift: np.ndarray      # (nv, 3) lattice translation of each virtual atom
    atom_radii: np.ndarray  # (natm,) Bragg radii of the real atoms

    @property
    def ngrid(self) -> int:
        return len(self.ratom)


def pbc_wrap_grid(spec: GridSpec, atompos, lattice, min_pts: int = 8
                  ) -> PBCGridSpec:
    """Wrap a molecular GridSpec into the unit cell (PBCGridSpec). Shifts
    holding `min_pts` or fewer points are dropped with their points, as
    PySCF does."""
    pos = (atompos.detach().cpu().numpy() if hasattr(atompos, "detach")
           else np.asarray(atompos))
    a = lattice._a_np
    binv = np.linalg.inv(a)                        # u = r @ binv
    coords = pos[spec.atom_idx] + spec.ratom[:, None] * spec.dirs
    ns = -np.floor(coords @ binv).astype(np.int64)             # (ng, 3)
    # virtual atoms: the unique (owner, shift) pairs with > min_pts points
    key = np.concatenate([spec.atom_idx[:, None], ns], axis=1)
    uniq, inv, cnt = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    inv = inv.reshape(-1)
    keep_u = cnt > min_pts
    keep_pt = keep_u[inv]
    new_id = -np.ones(len(uniq), dtype=np.int64)
    new_id[keep_u] = np.arange(int(keep_u.sum()))
    return PBCGridSpec(
        ratom=spec.ratom[keep_pt], dirs=spec.dirs[keep_pt],
        w0=spec.w0[keep_pt], atom_idx=spec.atom_idx[keep_pt],
        shift=ns[keep_pt] @ a, vatom_idx=new_id[inv[keep_pt]],
        vowner=uniq[keep_u, 0], vshift=uniq[keep_u, 1:] @ a,
        atom_radii=spec.atom_radii)


def _append_blocks(out, ia, r, wr, degs, rule=angular_rule):
    """Append per-radial-point angular shells, grouped by equal degree."""
    ratom, dirs, w0, aidx = out
    for d in np.unique(degs):
        sel = degs == d
        ang_pts, ang_w = rule(int(d))
        nang = len(ang_w)
        nsel = int(sel.sum())
        ratom.append(np.repeat(r[sel], nang))
        dirs.append(np.tile(ang_pts, (nsel, 1)))
        w0.append((wr[sel][:, None] * ang_w[None, :]).ravel())
        aidx.append(np.full(nsel * nang, ia, dtype=np.int32))


def get_predefined_grid(grid, atomzs: Sequence[int], atompos=None,
                        prune: bool = True, pbc: bool = False) -> GridSpec:
    """grid: int level 0-9 or "sg2"/"sg3".

    Integer levels: Treutler-M4 radial (per-Z xi, nr grows with period) x
    Lebedev angular, NWChem-style pruning near nuclei (prune=True).
    "sg2"/"sg3": the Dasgupta grids — uniform x DE2 (per-Z alpha,
    rmax = 15 * expected radius) radial, per-radial-slice Lebedev
    precisions from the published truncation tables (NWChem pruning for
    elements outside the tables). `atompos` is not needed: the spec is
    relative to the owning atom.

    pbc=True (the grid of a Sol, wrapped by pbc_wrap_grid): a named grid
    takes its (radial count, degree) on the Treutler radial grid with NWChem
    pruning, and every grid the product angular rules: wrapping moves outer
    points into neighbouring density maxima, which the Dasgupta truncation
    tables and the low Lebedev degrees under-resolve (the JAX package
    measured 1.7e-2 electrons of count error on an H cell of 3 Bohr with
    them, 3e-4 without)."""
    named = isinstance(grid, str)
    if named:
        key = grid.lower()
        if key not in _NAMED:
            raise ValueError(f"unknown grid {grid!r}; named grids: "
                             f"{sorted(_NAMED)}, or a level 0-9")
        nr_base, degree = _NAMED[key]
        alphas = _SG2_DE2_ALPHAS if key == "sg2" else _SG3_DE2_ALPHAS
        named = not pbc
    else:
        nr_base, degree = _LEVELS[int(grid)]
    out = ([], [], [], [])
    for ia, z in enumerate(atomzs):
        z = int(z)
        if named:
            nr = nr_base
            tf = DE2Transformation(alpha=alphas.get(z, 1.0), rmin=1e-7,
                                   rmax=15.0 * get_expected_radius(z))
            r, wr = radial_grid(nr, tf, quadrature="uniform")
            idxs = _DASGUPTA_IDX[nr].get(z)
            if prune and idxs is not None:
                degs = np.empty(nr, dtype=int)
                for i, p in enumerate(_DASGUPTA_PRECS[nr][z]):
                    degs[idxs[i]:idxs[i + 1]] = p
                _append_blocks(out, ia, r, wr, degs)
                continue
        else:
            nr = nr_base + 20 * (_period(z) - 1)
            xi = _TREUTLER_XI.get(z, 1.0)
            r, wr = radial_grid(nr, TreutlerM4Transformation(xi=xi))
        R = get_bragg_radius(z)
        if prune:
            degs = np.array([_pruned_degree(ri / R, degree) for ri in r])
        else:
            degs = np.full(nr, degree, dtype=int)
        _append_blocks(out, ia, r, wr, degs,
                       rule=product_angular_grid if pbc else angular_rule)
    ratom, dirs, w0, aidx = out
    radii = np.array([get_bragg_radius(int(z)) for z in atomzs])
    return GridSpec(ratom=np.concatenate(ratom),
                    dirs=np.concatenate(dirs, axis=0),
                    w0=np.concatenate(w0),
                    atom_idx=np.concatenate(aidx),
                    atom_radii=radii)
