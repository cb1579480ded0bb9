"""Basis-set loader (counterpart of dqc_tpu/basis/loader.py).

Offline-first: the standard sets are vendored as Python data modules in
basis/sets/ (the port's own copies). `parse_gaussian94` parses user-supplied
Gaussian94-format text. Directories of Gaussian94 files registered with
`register_basis_dir` (or listed in DQC_TPU_BASIS_PATH, colon-separated, at
import) take precedence over the vendored data for every name they cover;
they are the only source of a named fitting basis for
Mol.densityfit(auxbasis=...).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np

from ..utils.datastruct import CGTOBasis
from ..utils.periodictable import get_atomz

# registry: normalized basis name -> module with DATA dict
_NORMALIZE = lambda s: re.sub(r"[^a-z0-9+*]", "", s.lower())

_REGISTRY: Dict[str, str] = {
    _NORMALIZE("sto-3g"): "sto3g",
    _NORMALIZE("3-21g"): "p321g",
    _NORMALIZE("6-311++g**"): "p6311ppgss",
    _NORMALIZE("def2-svp"): "def2svp",
    _NORMALIZE("def2-sv(p)"): "def2svp",
    _NORMALIZE("cc-pvdz"): "ccpvdz",
}

# fitting-basis names recognised but not vendored; Mol.densityfit() without
# an auxbasis generates an even-tempered one (basis/autoaux.py)
_UNVENDORED_FIT = {_NORMALIZE("def2-svp-jkfit"),
                   _NORMALIZE("def2-universal-jkfit")}

_cache: Dict[str, dict] = {}
_nonverbatim: Dict[str, frozenset] = {}
_warned_nonverbatim: set = set()

# user basis directories, most recently registered first; file stem = basis
# name (e.g. "def2-svp-jkfit.gbs")
_basis_dirs: List[str] = []
_dir_file_cache: Dict[str, dict] = {}   # file path -> {Z: [raw CGTOBasis]}
_G94_EXTS = (".g94", ".gbs", ".bas", ".txt")


def register_basis_dir(path: str) -> None:
    """Put a directory of Gaussian94 basis files (*.g94/*.gbs/*.bas/*.txt;
    file stem = basis-set name) first on the lookup path."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"not a directory: {path!r}")
    if path in _basis_dirs:
        _basis_dirs.remove(path)
    _basis_dirs.insert(0, path)


def _seed_env_dirs() -> None:
    for p in reversed(os.environ.get("DQC_TPU_BASIS_PATH", "").split(":")):
        if p and os.path.isdir(p):
            register_basis_dir(p)


_seed_env_dirs()


def _dir_lookup(basisname: str):
    """Path of a file in a registered directory whose stem matches
    `basisname` (normalized comparison), or None."""
    key = _NORMALIZE(basisname)
    for d in _basis_dirs:
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        for f in names:
            stem, ext = os.path.splitext(f)
            if ext.lower() in _G94_EXTS and _NORMALIZE(stem) == key:
                return os.path.join(d, f)
    return None


def _dir_data(path: str) -> dict:
    if path not in _dir_file_cache:
        with open(path) as fh:
            _dir_file_cache[path] = parse_gaussian94(fh.read(),
                                                     normalize=False)
    return _dir_file_cache[path]


def list_basis_sets() -> List[str]:
    return sorted(set(_REGISTRY.values()))


def _get_data(basisname: str) -> dict:
    key = _NORMALIZE(basisname)
    if key in _UNVENDORED_FIT:
        raise ValueError(
            f"Fitting basis {basisname!r} is not vendored. Use "
            "Mol.densityfit() without an auxbasis for the generated "
            "even-tempered auxiliary set (basis/autoaux.py), or put the "
            "basis file in a directory given to register_basis_dir.")
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown basis set {basisname!r}; vendored sets: "
            f"{list_basis_sets()}. Pass a Gaussian94 string for custom bases.")
    modname = _REGISTRY[key]
    if modname not in _cache:
        import importlib
        mod = importlib.import_module(f".sets.{modname}", package=__package__)
        _cache[modname] = mod.DATA
        _nonverbatim[modname] = frozenset(getattr(mod, "NONVERBATIM", ()))
    return _cache[modname]


def _warn_if_nonverbatim(basisname: str, z: int) -> None:
    """One-time-per-element warning when a standard basis name serves
    digits that are not the verbatim published tables."""
    modname = _REGISTRY.get(_NORMALIZE(basisname))
    if modname is None or z not in _nonverbatim.get(modname, ()):
        return
    key = (modname, z)
    if key in _warned_nonverbatim:
        return
    _warned_nonverbatim.add(key)
    import warnings
    warnings.warn(
        f"Basis {basisname!r} for Z={z}: the vendored digits are not the "
        f"verbatim published tables (see the provenance tiers in "
        f"basis/sets/{modname}.py). Energies can deviate from literature "
        f"values computed with the standard set; pass Gaussian94 text for "
        f"exact published parity.",
        UserWarning, stacklevel=3)


def loadbasis(cmd: str, normalize: bool = True) -> List[CGTOBasis]:
    """Load a basis for one element.

    cmd: "<Z or symbol>:<basis name>" e.g. "1:3-21G" or "O:def2-SVP"."""
    if ":" not in cmd:
        raise ValueError("loadbasis expects '<element>:<basis name>'")
    elem, name = cmd.split(":", 1)
    z = get_atomz(elem.strip())
    name = name.strip()
    fpath = _dir_lookup(name)
    if fpath is not None:
        fdata = _dir_data(fpath)
        if z not in fdata:
            raise ValueError(
                f"Basis file {fpath!r} has no data for element Z={z}")
        out = [CGTOBasis(angmom=b.angmom,
                         alphas=np.array(b.alphas, dtype=np.float64),
                         coeffs=np.array(b.coeffs, dtype=np.float64))
               for b in fdata[z]]
        return [b.wfnormalize_() for b in out] if normalize else out
    data = _get_data(name)
    if z not in data:
        raise ValueError(f"Basis {name!r} has no data for element Z={z}")
    _warn_if_nonverbatim(name, z)
    res = []
    for (l, alphas, coeffs) in data[z]:
        b = CGTOBasis(angmom=l,
                      alphas=np.asarray(alphas, dtype=np.float64),
                      coeffs=np.asarray(coeffs, dtype=np.float64))
        res.append(b.wfnormalize_() if normalize else b)
    return res


_L_NAMES = {"s": 0, "p": 1, "d": 2, "f": 3, "g": 4, "h": 5, "i": 6}


def parse_gaussian94(text: str, normalize: bool = True) -> Dict[int, List[CGTOBasis]]:
    """Parse a Gaussian94-format basis block. Returns {Z: [CGTOBasis, ...]}."""
    out: Dict[int, List[CGTOBasis]] = {}
    lines = [ln.split("!")[0].rstrip() for ln in text.splitlines()]
    i = 0

    def _skip_blank(i):
        while i < len(lines) and (not lines[i].strip() or lines[i].strip() == "****"):
            i += 1
        return i
    i = _skip_blank(i)
    while i < len(lines):
        hdr = lines[i].split()
        if len(hdr) < 1:
            i += 1
            continue
        z = get_atomz(hdr[0])
        i += 1
        shells: List[CGTOBasis] = []
        while i < len(lines) and lines[i].strip() and lines[i].strip() != "****":
            sh = lines[i].split()
            lname, nprim = sh[0].lower(), int(sh[1])
            i += 1
            rows = []
            for _ in range(nprim):
                rows.append([float(x.replace("D", "E").replace("d", "e"))
                             for x in lines[i].split()])
                i += 1
            rows_np = np.asarray(rows)
            alphas = rows_np[:, 0]
            if lname == "sp":
                for col, l in ((1, 0), (2, 1)):
                    b = CGTOBasis(angmom=l, alphas=alphas, coeffs=rows_np[:, col])
                    shells.append(b.wfnormalize_() if normalize else b)
            else:
                b = CGTOBasis(angmom=_L_NAMES[lname], alphas=alphas,
                              coeffs=rows_np[:, 1])
                shells.append(b.wfnormalize_() if normalize else b)
        out[z] = shells
        i = _skip_blank(i)
    return out
