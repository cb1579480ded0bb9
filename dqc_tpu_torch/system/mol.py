"""Molecular system description (counterpart of dqc_tpu/system/mol.py).

Mol is built on the host. It produces (meta, params) — the static shell
metadata and the dict of differentiable tensors — plus occupation vectors;
all physics downstream is plain functions of params. `densityfit()` marks
the molecule for the density-fitted route of HF/KS (mol.dfinfo); `vext`, a
potential tabulated on the molecule's grid (mol.setup_grid(), one value per
point), is added to the core Hamiltonian. The on-disk cache is not ported
yet and raises NotImplementedError here.
"""
from __future__ import annotations

import math
from typing import List, Optional, Union

import numpy as np
import torch

from ..api.parser import parse_moldesc
from ..basis.loader import loadbasis, parse_gaussian94
from ..grid.factory import get_predefined_grid
from ..ops.shellstruct import pack_basis
from ..utils.config import DTYPE, resolve_device
from ..utils.datastruct import (AtomCGTOBasis, CGTOBasis, DensityFitInfo,
                                SpinParam)
from ..utils.periodictable import get_atomz
from ..utils.safeops import occnumber


def _load_atom_basis(z_int: int, basis) -> List[CGTOBasis]:
    if isinstance(basis, str):
        if "\n" in basis:  # raw Gaussian94 text
            return parse_gaussian94(basis, normalize=False)[z_int]
        return loadbasis(f"{z_int}:{basis}", normalize=False)
    if isinstance(basis, (list, tuple)) and basis and isinstance(basis[0], CGTOBasis):
        return list(basis)
    raise TypeError(f"Cannot interpret basis spec: {basis!r}")


def resolve_atom_bases(zs_int, basis) -> List[List[CGTOBasis]]:
    """Resolve a user basis spec into per-atom CGTOBasis lists.

    Accepted forms: a name, raw Gaussian94 text, a flat List[CGTOBasis]
    (same shells on every atom), a dict {Z or symbol: spec}, or a per-atom
    list of any of the above (including List[List[CGTOBasis]])."""
    out = []
    per_atom = (isinstance(basis, (list, tuple)) and len(basis) > 0
                and not isinstance(basis[0], CGTOBasis))
    if per_atom and len(basis) != len(zs_int):
        raise ValueError(
            f"per-atom basis list has {len(basis)} entries for "
            f"{len(zs_int)} atoms")
    for i, zi in enumerate(zs_int):
        if isinstance(basis, dict):
            key = zi if zi in basis else (
                [k for k in basis if get_atomz(k) == zi] or [None])[0]
            out.append(_load_atom_basis(zi, basis[key]))
        elif per_atom:
            out.append(_load_atom_basis(zi, basis[i]))
        else:
            out.append(_load_atom_basis(zi, basis))
    return out



def _host(x):
    """A float64 numpy copy of an array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)

class Mol:
    """Isolated molecule.

    moldesc: "H 1 0 0; H -1 0 0" or (atomzs, atompos in Bohr)
    basis: name, Gaussian94 text, dict {Z or symbol: spec}, or list per atom
    spin: 2*S_z (None -> 0 or 1 by electron parity); may be fractional
    charge: total charge; may be fractional
    orb_weights: optional occupation override — SpinParam of (nao,) tensors
    (polarized) or a (nao,) tensor (restricted)
    efield, efield_grad, efield_grad2: optional uniform field (3,), field
    gradient (3, 3) and second field gradient (3, 3, 3) coupled to the
    electrons
    vext: optional external potential (ng,) on the points of the molecule's
    grid (setup_grid()), in Hartree, added to the core Hamiltonian
    device: None means the CUDA card (RuntimeError without one); pass "cpu"
    to run on the CPU.
    """

    def __init__(self, moldesc, basis: Union[str, dict, list] = "3-21G", *,
                 spin: Optional[Union[int, float]] = None,
                 charge: Union[int, float] = 0,
                 orthogonalize_basis: bool = True,
                 efield=None,
                 efield_grad=None,
                 efield_grad2=None,
                 vext=None,
                 orb_weights=None,
                 grid: Union[int, str] = "sg3",
                 dtype=torch.float64,
                 device=None):
        if dtype != DTYPE:
            raise ValueError("dqc_tpu_torch computes in torch.float64 only")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.atomzs, self.atompos = parse_moldesc(moldesc, device=self.device)
        zs_concrete = self.atomzs.detach().cpu().numpy()
        pos_concrete = self.atompos.detach().cpu().numpy()
        self.zs_int = [int(round(float(z))) for z in zs_concrete]
        self._frac_z = any(abs(float(z) - zi) > 1e-12
                           for z, zi in zip(zs_concrete, self.zs_int))

        # basis per atom
        atombases = []
        for i, bas_i in enumerate(resolve_atom_bases(self.zs_int, basis)):
            atombases.append(AtomCGTOBasis(atomz=self.zs_int[i], bases=bas_i,
                                           pos=pos_concrete[i]))
        self.atombases = atombases
        self.meta, self.params = pack_basis(atombases, device=self.device)
        # keep positions as given (a tensor the caller owns keeps its graph)
        self.params["atompos"] = self.atompos

        # electrons / occupations
        nelec_tot = float(np.sum(zs_concrete)) - float(charge)
        if nelec_tot < 0:
            raise ValueError("More charge than electrons")
        self.charge = charge
        frac_elec = abs(nelec_tot - round(nelec_tot)) > 1e-12
        if spin is None:
            spin = 0 if round(nelec_tot) % 2 == 0 else 1
            if frac_elec:
                spin = nelec_tot - 2 * math.floor(nelec_tot / 2.0)
        self.spin = spin
        nup = (nelec_tot + float(spin)) / 2.0
        ndn = (nelec_tot - float(spin)) / 2.0
        if ndn < -1e-12:
            raise ValueError("spin > number of electrons")
        self.nelec = (nup, ndn)
        self.polarized = float(spin) != 0.0
        self._orb_weights = orb_weights
        if isinstance(orb_weights, SpinParam):
            self.polarized = True
        self.efield = efield
        self.efield_grad = efield_grad
        self.efield_grad2 = efield_grad2
        self.vext = vext
        self.orthogonalize_basis = orthogonalize_basis
        self.grid_level = grid
        self._grid = None
        self._dfinfo = None
        self._cache_fname = None
        self._cache_paramnames = None

    def _t(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # --- occupations -----------------------------------------------------
    def get_orb_weights(self, polarized: Optional[bool] = None):
        """Occupation vector(s) over nao orbitals sorted by energy.

        restricted -> (nao,) with weights up to 2;
        polarized -> SpinParam of (nao,)."""
        pol = self.polarized if polarized is None else polarized
        if self._orb_weights is not None:
            w = self._orb_weights
            if isinstance(w, SpinParam):
                if not pol:
                    raise ValueError(
                        "SpinParam orb_weights requires a polarized calc")
                return SpinParam(u=self._t(w.u), d=self._t(w.d))
            if pol:
                half = 0.5 * self._t(w)
                return SpinParam(u=half, d=half)
            return self._t(w)
        nao = self.meta.nao
        nup, ndn = self.nelec
        if pol:
            wu = occnumber(nup, nao, self.dtype, self.device)
            wd = occnumber(ndn, nao, self.dtype, self.device)
            return SpinParam(u=wu, d=wd)
        if abs(nup - ndn) > 1e-12:
            raise ValueError("Restricted calculation requires spin 0")
        return 2.0 * occnumber(nup, nao, self.dtype, self.device)

    # --- density fitting -------------------------------------------------
    def densityfit(self, method: str = "coulomb", auxbasis="autoaux"):
        """Use density fitting for the two-electron integrals of HF/KS;
        returns the molecule. auxbasis: "autoaux" for the generated
        even-tempered fit (basis/autoaux.py), or any basis spec of Mol's
        `basis` argument (a name is looked up in the registered basis
        directories first, basis/loader.register_basis_dir)."""
        if method != "coulomb":
            raise NotImplementedError(
                f"density-fitting method {method!r}: only 'coulomb' exists")
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

    @property
    def dfinfo(self) -> Optional[DensityFitInfo]:
        return self._dfinfo

    def set_cache(self, fname: str, paramnames=None):
        """Cache theta's expensive tensors (integrals, grid tables) on disk
        in the .npz file fname, under this molecule's cache_signature
        (utils/cache.py); run() then loads what the file holds and builds
        and stores the rest. paramnames limits the cache to the named theta
        parts, the JAX package's names: "core" (one-electron integrals and,
        on the dense route, eri_k), "grid", "df", "jk" and "warmdf"
        (streamed route), "jkb{i}" (blocked), "erilr{i}", "dflr{i}"; None
        caches every part. Derivatives never read the cache."""
        self._cache_fname = fname
        self._cache_paramnames = (None if paramnames is None
                                  else list(paramnames))
        return self

    @property
    def cache_signature(self) -> str:
        """The system's signature in the cache file: the JAX package's
        string for the same system (positions rounded to 1e-10 Bohr,
        charges, every shell's exponents and coefficients, vext, grid
        level, angular rule, charge and spin)."""
        import hashlib
        from ..grid.angular import angular_rule_tag
        pos = np.round(_host(self.atompos), 10).tobytes()
        zs = np.asarray(self.zs_int).tobytes()
        shells = str([(b.angmom,
                       ["%.10e" % float(a) for a in np.asarray(b.alphas)],
                       ["%.10e" % float(c) for c in np.asarray(b.coeffs)])
                      for ab in self.atombases for b in ab.bases])
        vext_b = (b"" if self.vext is None
                  else np.round(_host(self.vext), 10).tobytes())
        h = hashlib.sha256(pos + zs + shells.encode() + vext_b).hexdigest()[:16]
        return (f"mol2-{h}-grid{self.grid_level}-{angular_rule_tag()}"
                f"-q{self.charge}-s{self.spin}")

    def setup_grid(self):
        """The molecule's integration grid (grid/factory.GridSpec, host
        numpy, relative to the atoms; built once)."""
        if self._grid is None:
            self._grid = get_predefined_grid(self.grid_level, self.zs_int)
        return self._grid

    def make_copy(self, **kwargs):
        """A new Mol with some constructor arguments changed (geometry
        scans and the like; the JAX package's make_copy,
        dqc_tpu/system/mol.py:233-246): `atompos` replaces the positions,
        any other keyword the argument of that name; the rest, the device
        and the occupation override among them, carry over (the basis as
        the resolved per-atom shells). densityfit() is not carried over."""
        opts = dict(
            moldesc=(self.atomzs,
                     kwargs.pop("atompos", self.params["atompos"])),
            basis=kwargs.pop("basis", None),
            spin=self.spin, charge=self.charge,
            orthogonalize_basis=self.orthogonalize_basis,
            efield=self.efield, efield_grad=self.efield_grad,
            efield_grad2=self.efield_grad2, vext=self.vext,
            orb_weights=self._orb_weights, grid=self.grid_level,
            device=self.device)
        if opts["basis"] is None:
            opts["basis"] = [ab.bases for ab in self.atombases]
        opts.update(kwargs)
        return Mol(opts.pop("moldesc"), **opts)

    def get_nuclei_energy(self):
        from ..scf.hamilton import nuclear_repulsion
        return nuclear_repulsion(self.atomzs, self.params["atompos"])
