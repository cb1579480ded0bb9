"""Molecular properties by differentiating the SCF energy (counterpart of
dqc_tpu/api/properties.py, with its units, unit strings and conventions):
hessian_pos, vibration, ir_spectrum, raman_spectrum, edipole, equadrupole,
eoctupole, polarizability, optimal_geometry, lowest_eival_orb_hessian and
is_orb_min.

Each property is a derivative of qc.energy_fn(params) through the implicit
derivative of the SCF fixed point (scf/fixed_point.py), exact at
convergence to any order. Where the JAX package composes jax.grad,
jax.hessian and jax.jacfwd, a second derivative here is one forward of
energy_fn, one first backward with create_graph=True and one second
backward per column (retain_graph=True): the forward and the first
backward are not redone per column. The Raman spectrum's third derivative
dalpha/dR takes the field Hessian with its graph kept and one more
backward per entry. Only the entries a property needs take a gradient
(qc._leaves(wrt=...)): the fields for the multipoles and the
polarizability, the atom positions and the field for the Hessian, IR and
Raman; so a field derivative forms no cotangent of the basis parameters or
of an ERI tensor. The zero fields a property differentiates are added to
qc._all_params() here, as the JAX package's eoctupole adds its (3, 3, 3)
one. The JAX package's split-module route for second derivatives
(_use_adjoint, scf/adjoint.py) serves its TPU compiler and has no
counterpart.

Records: qc.stats["props"][name] has the seconds of the forward, the first
backward and the columns of each derivative and its GMRES records
(scf/fixed_point.py); optimal_geometry's has the BFGS record.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..scf.engine import orthogonal_fock_to_dm
from ..utils.optimize import minimize_bfgs
from ..utils.periodictable import get_atom_mass
from ..utils.units import (AU_TO_DEBYE, BOHR_TO_ANGSTROM, FREQ_AU_TO_CM1,
                           IR_INT_AU_TO_KMMOL, RAMAN_AU_TO_ANGST4_AMU)

__all__ = ["hessian_pos", "vibration", "ir_spectrum", "raman_spectrum",
           "edipole", "equadrupole", "eoctupole", "polarizability",
           "optimal_geometry", "lowest_eival_orb_hessian", "is_orb_min"]

_FIELD_SHAPES = {"efield": (3,), "efield_grad": (3, 3),
                 "efield_grad2": (3, 3, 3)}
POS = ("basis", "atompos")


def _memo(qc, key, compute):
    """Per-calc property cache (the JAX package's _memo): ir_spectrum and
    raman_spectrum reuse the vibration Hessian."""
    cache = qc.__dict__.setdefault("_prop_cache", {})
    if key not in cache:
        cache[key] = compute()
    return cache[key]


def _params(qc, *fields):
    """qc._all_params() with zero placeholders for the named fields the
    molecule does not have."""
    p = qc._all_params()
    mol = qc.mol
    for f in fields:
        if f not in p:
            p[f] = torch.zeros(_FIELD_SHAPES[f], dtype=mol.dtype,
                               device=mol.device)
    return p


def _at(p, path):
    for k in path:
        p = p[k]
    return p


class _Record:
    """Seconds by stage and the GMRES records of one property, in
    qc.stats["props"][name]."""

    def __init__(self, qc, name):
        if not qc._has_run:
            qc.run()
        self.qc = qc
        qc.stats["gmres"] = []
        self.rec = qc.stats.setdefault("props", {})[name] = {}
        self.t = time.perf_counter()

    def lap(self, key):
        self.qc._sync()
        now = time.perf_counter()
        self.rec[key] = self.rec.get(key, 0.0) + now - self.t
        self.t = now

    def close(self):
        self.rec["gmres"] = list(self.qc.stats["gmres"])


def _columns(g, x, create=False):
    """d g[i] / dx for every entry i of g, which has its graph in x: a
    (g.numel(), *x.shape) tensor, one backward per entry."""
    rows = []
    flat = g.reshape(-1)
    for i in range(flat.numel()):
        (h,) = torch.autograd.grad(flat[i], x, retain_graph=True,
                                   create_graph=create, allow_unused=True)
        rows.append(torch.zeros_like(x) if h is None else h)
    return torch.stack(rows)


def _energy(qc, rec, fields, wrt):
    """(E, params) with E = qc.energy_fn(params) built with the entries
    `wrt` of the calc's params (the named zero fields added) as leaves."""
    pp, _ = qc._leaves(_params(qc, *fields), wrt=wrt)
    e = qc.energy_fn(pp)
    rec.lap("forward_s")
    return e, pp


def _first(qc, name, field):
    """dE/d(field) at the calc's params."""
    rec = _Record(qc, name)
    with torch.enable_grad():
        e, pp = _energy(qc, rec, (field,), [(field,)])
        (g,) = torch.autograd.grad(e, pp[field])
    rec.lap("backward_s")
    rec.close()
    return g


def _second(qc, name, fields, a, b):
    """d^2 E / da db at the calc's params, (a.numel(), b.numel()), for the
    key paths a and b: one forward, one backward in a with its graph
    kept, one backward in b per entry of a."""
    rec = _Record(qc, name)
    with torch.enable_grad():
        e, pp = _energy(qc, rec, fields, [a] if a == b else [a, b])
        (g,) = torch.autograd.grad(e, _at(pp, a), create_graph=True)
        rec.lap("backward_s")
        h = _columns(g, _at(pp, b)).reshape(g.numel(), -1)
    rec.lap("columns_s")
    rec.close()
    return h


def hessian_pos(qc):
    """d^2 E / dpos^2, (natoms*3, natoms*3), symmetrised (the JAX
    package's hessian_pos)."""
    def go():
        h = _second(qc, "hessian_pos", (), POS, POS)
        return 0.5 * (h + h.T)
    return _memo(qc, "hessian_pos", go)


def _mass_vector(qc):
    mol = qc.get_system()
    return torch.as_tensor(np.repeat([get_atom_mass(z) for z in mol.zs_int],
                                     3), dtype=mol.dtype, device=mol.device)


def vibration(qc, freq_unit: str = "cm^-1"):
    """Harmonic frequencies and normal modes from the mass-weighted
    Hessian: (freqs (natoms*3,) descending, modes (natoms*3, natoms*3));
    an imaginary frequency is reported negative."""
    hess = hessian_pos(qc)
    m = torch.sqrt(_mass_vector(qc))
    w, v = torch.linalg.eigh(hess / m[:, None] / m[None, :])
    freqs = torch.sign(w) * torch.sqrt(torch.abs(w))
    if freq_unit in ("cm^-1", "cm-1"):
        freqs = freqs * FREQ_AU_TO_CM1
    order = torch.argsort(-freqs)
    return freqs[order], v[:, order]


def edipole(qc, unit: str = "a.u."):
    """Electric dipole moment -dE/dE_field plus the nuclear dipole, (3,);
    unit "a.u." or "debye"."""
    p = qc._all_params()
    mu = -_first(qc, "edipole", "efield") + torch.einsum(
        "a,ad->d", p["atomzs"], p["basis"]["atompos"].detach())
    return mu * AU_TO_DEBYE if unit.lower() == "debye" else mu


def polarizability(qc, unit: str = "a.u."):
    """Static dipole polarizability alpha = -d^2 E / dE_field^2, (3, 3),
    symmetrised; unit "a.u." or "angst^3"."""
    a = -_second(qc, "polarizability", ("efield",), ("efield",),
                 ("efield",))
    return _alpha_unit(0.5 * (a + a.T), unit)


def _alpha_unit(alpha, unit):
    if unit.lower() in ("angst^3", "angstrom^3"):
        return alpha * BOHR_TO_ANGSTROM ** 3
    if unit.lower() != "a.u.":
        raise ValueError(f"unknown polarizability unit {unit!r}")
    return alpha


def equadrupole(qc, unit: str = "a.u."):
    """Electric quadrupole moment in the second-moment form, (3, 3):
    -2 dE/dG plus sum_A Z_A R_A R_A^T; unit "a.u." or "debye*angst"."""
    p = qc._all_params()
    pos = p["basis"]["atompos"].detach()
    q = -2.0 * _first(qc, "equadrupole", "efield_grad") + torch.einsum(
        "a,ad,ae->de", p["atomzs"], pos, pos)
    if unit.lower() in ("debye*angst", "debye*angstrom"):
        return q * (AU_TO_DEBYE * BOHR_TO_ANGSTROM)
    if unit.lower() != "a.u.":
        raise ValueError(f"unknown quadrupole unit {unit!r}")
    return q


def eoctupole(qc):
    """Electric octupole moment in the third-moment form, (3, 3, 3), a.u.:
    -6 dE/dG2 (the (1/3!) r r r coupling of the second field gradient)
    plus sum_A Z_A R_A R_A R_A."""
    p = qc._all_params()
    pos = p["basis"]["atompos"].detach()
    return -6.0 * _first(qc, "eoctupole", "efield_grad2") + torch.einsum(
        "a,ad,ae,af->def", p["atomzs"], pos, pos, pos)


def _normal(qc, modes):
    return modes / torch.sqrt(_mass_vector(qc))[:, None]


def ir_spectrum(qc, freq_unit: str = "cm^-1", ints_unit: str = "km/mol"):
    """(freqs, IR intensities |dmu/dQ|^2) per normal mode; ints_unit
    "km/mol", or None for atomic units. dmu/dR is the mixed second
    derivative -d^2 E / dE_field dR plus the nuclear Z_A I blocks."""
    freqs, modes = vibration(qc, freq_unit)
    dmu = -_second(qc, "ir_spectrum", ("efield",), ("efield",), POS)
    zs = qc._all_params()["atomzs"]
    eye = torch.eye(3, dtype=dmu.dtype, device=dmu.device)
    dmu = dmu + torch.einsum("a,de->dae", zs, eye).reshape(3, -1)
    inten = torch.sum((dmu @ _normal(qc, modes)) ** 2, dim=0)
    if ints_unit is not None:
        if ints_unit.lower() != "km/mol":
            raise ValueError(f"unknown ints_unit {ints_unit!r}")
        inten = inten * IR_INT_AU_TO_KMMOL
    return freqs, inten


def _dalpha_dpos(qc):
    """(alpha (3, 3), dalpha/dR (3, 3, natoms*3)): the third derivative
    -d^3 E / dE_field^2 dR from the field Hessian with its graph kept
    (three backwards), then one backward in R per entry of its upper
    triangle."""
    rec = _Record(qc, "raman_spectrum")
    with torch.enable_grad():
        e, pp = _energy(qc, rec, ("efield",), [("efield",), POS])
        field, pos = pp["efield"], _at(pp, POS)
        (g,) = torch.autograd.grad(e, field, create_graph=True)
        rec.lap("backward_s")
        h = _columns(g, field, create=True)
        rec.lap("hessian_s")
        da = torch.zeros((3, 3, pos.numel()), dtype=h.dtype, device=h.device)
        for i in range(3):
            for j in range(i, 3):
                (d,) = torch.autograd.grad(h[i, j], pos, retain_graph=True)
                da[i, j] = da[j, i] = -d.reshape(-1)
    rec.lap("columns_s")
    rec.close()
    return -h.detach(), da


def raman_spectrum(qc, freq_unit: str = "cm^-1",
                   ints_unit: str = "angst^4/amu"):
    """(freqs, Raman activities 45 a'^2 + 7 gamma'^2 of dalpha/dQ) per
    normal mode; ints_unit "angst^4/amu", or None for atomic units.
    dalpha/dR is a third derivative of the energy (_dalpha_dpos)."""
    freqs, modes = vibration(qc, freq_unit)
    _, da = _dalpha_dpos(qc)
    da_dq = torch.einsum("deq,qm->dem", da, _normal(qc, modes))
    a_p = torch.diagonal(da_dq, dim1=0, dim2=1).sum(-1) / 3.0
    diff = da_dq - a_p[None, None, :] * torch.eye(
        3, dtype=da.dtype, device=da.device)[:, :, None]
    gamma2 = 1.5 * torch.einsum("dem,dem->m", diff, diff)
    activity = 45.0 * a_p ** 2 + 7.0 * gamma2
    if ints_unit is not None:
        if ints_unit.lower() not in ("angst^4/amu", "angstrom^4/amu"):
            raise ValueError(f"unknown ints_unit {ints_unit!r}")
        activity = activity * RAMAN_AU_TO_ANGST4_AMU
    return freqs, activity


def optimal_geometry(qc, maxiter: int = 200, tol: float = 1e-6):
    """Atom positions (natoms, 3) that minimise the SCF energy: BFGS over
    the flattened positions with the implicit-differentiation forces
    (utils/optimize.minimize_bfgs; tol is the max |gradient| it stops at).
    The BFGS record goes to qc.stats["props"]["optimal_geometry"]."""
    if not qc._has_run:
        qc.run()
    p0 = qc._all_params()
    pos0 = p0["basis"]["atompos"].detach()

    def energy(x):
        return qc.energy_fn(dict(p0, basis=dict(
            p0["basis"], atompos=x.reshape(pos0.shape))))

    t0 = time.perf_counter()
    x, info = minimize_bfgs(energy, pos0.reshape(-1), maxiter, tol)
    qc.stats.setdefault("props", {})["optimal_geometry"] = dict(
        info, seconds=time.perf_counter() - t0)
    return x.reshape(pos0.shape)


def lowest_eival_orb_hessian(qc):
    """Lowest eigenvalue of the Hessian of the energy in orbital rotations
    at the converged SCF, dm(K) = C expm((K - K^T)/2) occ (...)^T over the
    full (n, n) K per spin (the JAX package's lowest_eival_orb_hessian);
    negative means a saddle point."""
    rec = _Record(qc, "lowest_eival_orb_hessian")
    eng, theta = qc.engine, qc._theta
    with torch.no_grad():
        fock = eng.fock(qc._dm, theta)
        _, _, c = orthogonal_fock_to_dm(fock, theta["X"], theta["keep"],
                                        theta["occ"])
    occ = theta["occ"]
    with torch.enable_grad():
        k0 = torch.zeros(c.shape, dtype=c.dtype, device=c.device,
                         requires_grad=True)
        cr = c @ torch.linalg.matrix_exp(0.5 * (k0 - k0.transpose(-1, -2)))
        e = eng.energy((cr * occ[..., None, :]) @ cr.transpose(-1, -2),
                       theta)
        rec.lap("forward_s")
        (g,) = torch.autograd.grad(e, k0, create_graph=True)
        rec.lap("backward_s")
        h = _columns(g, k0).reshape(k0.numel(), -1)
    rec.lap("columns_s")
    rec.close()
    return torch.linalg.eigvalsh(0.5 * (h + h.T))[0]


def is_orb_min(qc, threshold: float = -1e-6) -> bool:
    """Whether the SCF solution is a minimum in orbital-rotation space."""
    return bool(lowest_eival_orb_hessian(qc) > threshold)
