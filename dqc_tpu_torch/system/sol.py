"""Periodic solid (counterpart of dqc_tpu/system/sol.py): atoms in a cell of
lattice vectors `alattice`, the Ewald nuclei energy, k-points, and the
periodic Hamiltonian's hooks. HF/KS of a Sol run at the Gamma point, or
with k-points on the k-point engine (scf/qccalc.py, scf/kpbc.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..api.parser import parse_moldesc
from ..grid.factory import get_predefined_grid, pbc_wrap_grid
from ..ops.pbc import estimate_rcut, pbc_kinetic, pbc_overlap
from ..ops.shellstruct import pack_basis
from ..utils.config import DTYPE, resolve_device
from ..utils.datastruct import AtomCGTOBasis, DensityFitInfo, SpinParam
from ..utils.safeops import occnumber
from .lattice import Lattice, ewald_energy
from .mol import _host, resolve_atom_bases


class Sol:
    """Periodic solid: soldesc ("H 0 0 0; ..." or (atomzs, atompos), Bohr)
    and lattice vectors `alattice` (3, 3) in rows, Bohr. The cell is
    neutral (no charge argument); spin is 2 S_z (default: the parity of the
    electron count); kpts (nk, 3), in Bohr^-1, default to the Gamma point
    alone (more than one k-point, or one away from Gamma, takes the k-point
    engine; a mesh's weights are uniform); grid is
    the XC grid, wrapped into the cell (grid/factory.pbc_wrap_grid).
    device: None means the CUDA card (RuntimeError without one); pass "cpu"
    to run on the CPU. efield, efield_grad, efield_grad2 and vext are None:
    a periodic cell takes no external field."""

    def __init__(self, soldesc, alattice, basis="3-21G", *,
                 spin: Optional[int] = None, kpts=None, grid="sg2",
                 device=None):
        self.device = resolve_device(device)
        self.dtype = DTYPE
        self.atomzs, self.atompos = parse_moldesc(soldesc, device=self.device)
        self.zs_int = [int(round(float(z)))
                       for z in self.atomzs.detach().cpu().numpy()]
        self.lattice = Lattice(alattice, device=self.device)
        pos_np = self.atompos.detach().cpu().numpy()
        self.atombases = [
            AtomCGTOBasis(atomz=zi, bases=bas_i, pos=pos_np[i])
            for i, (zi, bas_i) in enumerate(zip(
                self.zs_int, resolve_atom_bases(self.zs_int, basis)))]
        self.meta, self.params = pack_basis(self.atombases,
                                            device=self.device)
        self.params["atompos"] = self.atompos
        nelec = sum(self.zs_int)
        self.spin = spin if spin is not None else nelec % 2
        self.nelec = ((nelec + self.spin) / 2.0, (nelec - self.spin) / 2.0)
        self.polarized = self.spin != 0
        self.kpts = np.zeros((1, 3)) if kpts is None else np.asarray(
            kpts, dtype=np.float64)
        if self.kpts.ndim != 2 or self.kpts.shape[1] != 3 or \
                len(self.kpts) == 0 or not np.all(np.isfinite(self.kpts)):
            raise ValueError(f"kpts must be a finite (nk, 3) array with nk "
                             f">= 1, got shape {self.kpts.shape}")
        self.grid_level = grid
        self.efield = self.efield_grad = self.efield_grad2 = None
        self.vext = None
        self._grid = None
        self._dfinfo = None
        self._cache_fname = None
        self._cache_paramnames = None

    def _t(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    @property
    def dfinfo(self) -> Optional[DensityFitInfo]:
        return self._dfinfo

    def densityfit(self, method: str = "aft", auxbasis="autoaux"):
        """method "aft" (the default route: the pair transforms already
        play the fit's part) leaves the cell as it is; "gdf" fits the pair
        densities onto an auxiliary basis in the periodic Coulomb metric
        (scf/pbc.build_pbc_gdf), so J and K become products with one
        factor of nao^2 naux; "coulomb" is another name for "gdf".
        auxbasis: "autoaux" or any basis spec of the `basis` argument.
        Returns the cell."""
        if method == "aft":
            return self
        if method not in ("gdf", "coulomb"):
            raise ValueError(f"periodic density fitting {method!r}: 'aft', "
                             "'gdf' or 'coulomb'")
        method = "gdf"
        if isinstance(auxbasis, str) and auxbasis.lower() == "autoaux":
            from ..basis.autoaux import autoaux
            auxb = autoaux(self.atombases)
        else:
            auxb = [AtomCGTOBasis(atomz=zi, bases=bas_i, pos=ab.pos)
                    for zi, bas_i, ab in zip(
                        self.zs_int, resolve_atom_bases(self.zs_int, auxbasis),
                        self.atombases)]
        self._dfinfo = DensityFitInfo(method=method, auxbases=auxb)
        return self

    def get_orb_weights(self, polarized: Optional[bool] = None):
        """Occupations over nao orbitals: (nao,) restricted, SpinParam of
        (nao,) polarized."""
        nao = self.meta.nao
        nup, ndn = self.nelec
        pol = self.polarized if polarized is None else polarized
        if pol:
            return SpinParam(u=occnumber(nup, nao, self.dtype, self.device),
                             d=occnumber(ndn, nao, self.dtype, self.device))
        if abs(nup - ndn) > 1e-12:
            raise ValueError("Restricted calculation requires spin 0")
        return 2.0 * occnumber(nup, nao, self.dtype, self.device)

    def setup_grid(self):
        """The cell-wrapped grid (grid/factory.PBCGridSpec, host numpy,
        built once from the construction geometry)."""
        if self._grid is None:
            spec = get_predefined_grid(self.grid_level, self.zs_int,
                                       pbc=True)
            self._grid = pbc_wrap_grid(spec, self.atompos, self.lattice)
        return self._grid

    def set_cache(self, fname: str, paramnames=None):
        """Cache theta on disk in the .npz file fname (Mol.set_cache): a
        cell's theta is one part, "all", as in the JAX package."""
        self._cache_fname = fname
        self._cache_paramnames = (None if paramnames is None
                                  else list(paramnames))
        return self

    @property
    def cache_signature(self) -> str:
        """The JAX package's signature string of the same cell (positions
        and lattice rounded to 1e-10 Bohr, charges, grid level, spin). It
        leaves out the basis and the k-points; cache_fingerprint adds
        them."""
        import hashlib
        pos = np.round(_host(self.atompos), 10).tobytes()
        zs = np.asarray(self.zs_int).tobytes()
        lat = np.round(_host(self.lattice.lattice_vectors()), 10).tobytes()
        h = hashlib.sha256(pos + zs + lat).hexdigest()[:16]
        return f"sol-{h}-grid{self.grid_level}-s{self.spin}"

    @property
    def cache_fingerprint(self) -> str:
        """What the JAX package's signature of a cell does not hold: every
        shell's exponents and coefficients and the k-points. The port's
        cache checks it beside the signature, so a file written for
        another basis or mesh of the same cell is not read."""
        import hashlib
        shells = str([(b.angmom,
                       ["%.10e" % float(a) for a in np.asarray(b.alphas)],
                       ["%.10e" % float(c) for c in np.asarray(b.coeffs)])
                      for ab in self.atombases for b in ab.bases])
        kp = np.round(np.asarray(self.kpts, dtype=np.float64), 10).tobytes()
        return hashlib.sha256(shells.encode() + kp).hexdigest()[:16]

    def get_nuclei_energy(self):
        """The Ewald energy of the nuclei in a neutralising background."""
        return ewald_energy(self.atomzs, self.params["atompos"], self.lattice)

    def _translations(self, precision):
        return self.lattice.get_lattice_ls(
            estimate_rcut(self.meta, self.params, precision))

    def pbc_overlap(self, precision: float = 1e-10):
        """Lattice-summed overlap at the k-points: complex (nk, nao, nao)."""
        return pbc_overlap(self.meta, self.params,
                           self._translations(precision), self.kpts)

    def pbc_kinetic(self, precision: float = 1e-10):
        """Lattice-summed kinetic matrix at the k-points: complex (nk, nao,
        nao)."""
        return pbc_kinetic(self.meta, self.params,
                           self._translations(precision), self.kpts)
