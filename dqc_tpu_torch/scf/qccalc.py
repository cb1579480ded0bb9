"""User-facing SCF front ends: HF and KS (counterpart of
dqc_tpu/scf/qccalc.py).

HF(mol).run() -> qc; KS(mol, xc="b3lyp").run() -> qc; qc.energy(),
qc.aodm(), qc.dm2energy(dm), qc.dm2dens(coords); derivatives:
qc.energy_grad() (dE/dparams; forces are -g["basis"]["atompos"]) and the
differentiable qc.solve_dm(params) and qc.energy_fn(params), to any order
(api/properties.py builds Hessians and third derivatives on them);
qc.energy_hvp(v), a Hessian-vector product by double backward.

The JAX package has two routes through run(): one compiled solver for small
systems and a host-driven ladder of f32 and f64 phases for large ones, made
for f64 emulation and remote compiles on the TPU. The port has one loop in
float64 with the meaning of the small-system solver:
  f0 -> diis_solve(step_and_err) -> dm_from_fock(f_star) -> energy.
A molecule without densityfit() takes the dense route (eri_dense in the
exchange layout eri_k; a range-separated hybrid adds one erf-attenuated ERI
per distinct omega in the same layout) while its tensors fit
config.DENSE_ERI_BYTES_LIMIT; past it the blocked route (the canonical
quartet blocks of scf/jk.py cached in theta) while they fit
config.BLOCKED_JK_BYTES_LIMIT, and past that the streamed route
(integral-direct: the blocks rebuilt on every Fock build). One with
densityfit() takes the density-fitted route (scf/df.build_df_theta in the
molecule's aux basis, and one attenuated-metric fit per omega), which builds
no nao^4 tensor. KS adds the grid tables. The streamed route's SCF iterates
on an RI fit in the autoaux basis first, then polishes with exact J/K at RI
cost (_stream_solve), as the JAX package's host-driven solver does. Above
GUESS_NAO the SCF starts from the superposition of atomic densities
(sad_dm0), as in the JAX package; each atom takes the route its size
gives it. HF/KS(variational=True), or SCFOptions(method="variational"),
minimise the energy over orbital rotations by BFGS instead of DIIS
(_variational_solver). A molecule's grid-tabulated external potential
(Mol(vext=...)) is added to hcore on every route. A periodic cell (Sol)
runs at the Gamma point (_pbc_calc): theta from scf/pbc.build_pbc_core_theta
(the pair-Fourier-transform route "aft", or "gdf" after
sol.densityfit(method="gdf")) and, for KS, the cell-wrapped grid tables of
setup_pbc_grid_theta; a Sol with k-points (more than one, or one away from
Gamma) runs on the k-point engine of scf/kpbc.py (_kpbc_calc), its state
the stacked (re, im) real form of the complex D^k, so the solver, the
implicit derivatives and their real algebra are the same.

Derivatives follow the JAX package's energy_fn: theta is rebuilt from the
params in the autograd graph (one-electron integrals, the in-graph
orthogonaliser X of safe_eigh, eri_dense and its eri_k layout, the
blocks or the streamed route's Hermite factors, the grid points, Becke
weights and AO tables, which move with the atoms), and the converged dm is
`implicit_fixed_point(engine.step, ...)` of it (the DF fits are rebuilt
there too, their aux centres tied to the atoms; the streamed route's RI fit
only steers its solver and is built without a graph), started from the dm
of run(). The JAX package's split-module adjoint (scf/adjoint.py),
made for a remote TPU compiler, has no counterpart: one backward through
that graph is the same gradient.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..basis.autoaux import autoaux
from ..ops.aoeval import eval_ao
from ..ops.eri import eri_dense, screened_pair_classes
from ..ops.pbc import estimate_rcut
from ..ops.shellstruct import nsph, pack_basis
from ..utils.cache import Cache
from ..utils.config import config
from ..utils.datastruct import SpinParam, tree_batch_of_one, tree_member
from ..utils.logger import log
from ..utils.optimize import minimize_bfgs
from ..xc import get_xc
from ..xc.custom import CustomXC
from ..xc.integrate import (_detached, density_from_tables,
                             setup_grid_theta, vext_matrix)
from .df import build_df_theta
from .engine import HFEngine, KSEngine
from .fixed_point import (SCFOptions, diis_solve, diis_solve_batch,
                          implicit_fixed_point)
from .hamilton import build_core_theta
from .jk import (build_jk_blocks, build_jk_factors, build_jk_meta,
                 factors_to_theta, jk_blocks_nbytes, jk_combos)
from .orth import LARGE
from .kpbc import (KPBCEngine, build_kpbc_theta, has_kpoints, join,
                   kmesh_supercell)
from .pbc import (AO_PRECISION, CORE_PRECISION, build_pbc_core_theta,
                  madelung_constant, setup_pbc_grid_theta)

# at and above this nao the SCF starts from the Fock matrix of the SAD
# density (guess="sad", the default) or the GWH Fock (guess="gwh"); below it
# from the core guess, as the JAX package's two routes do
GUESS_NAO = 96
# the variational solver's BFGS stops at this max |dE/dparams| (the JAX
# package's gtol, dqc_tpu/scf/qccalc.py:245)
VAR_GTOL = 1e-9
ORB_PARAMS = ("matexp", "qr", "ov")


def _start_orbitals(X, keep, f0):
    """(C0, U0) of the variational solver: the eigenvectors U0 of the start
    Fock f0 ([B,] [2,] n, n) in the orthogonal basis of X ([B,] n, n), the
    directions that keep ([B,] n) drops pinned at LARGE, and C0 = X U0."""
    if f0.ndim > X.ndim:                      # a spin axis
        X, keep = X.unsqueeze(-3), keep.unsqueeze(-2)
    pin = torch.where(keep, torch.zeros_like(X[..., 0, :]),
                      torch.full_like(X[..., 0, :], LARGE))
    _, u0 = torch.linalg.eigh(
        torch.einsum("...im,...ij,...jn->...mn", X, f0, X)
        + torch.diag_embed(pin))
    return torch.einsum("...ij,...jk->...ik", X, u0), u0


def _occ_array(mol, polarized):
    w = mol.get_orb_weights(polarized)
    if isinstance(w, SpinParam):
        return torch.stack([w.u, w.d], dim=0)
    return w


def _screened(mol):
    """Schwarz-pruned pair lists, computed once from the molecule's initial
    params (the pruning pattern is frozen)."""
    if not getattr(mol, "screen", True) or mol.meta.nshell < 24:
        return None
    return screened_pair_classes(mol.meta, mol.params)


def gwh_fock(theta, polarized: bool):
    """Generalized Wolfsberg-Helmholtz initial Fock — a far better start
    than the bare core guess for large molecules (of every member of a
    stacked theta too)."""
    h, s = theta["hcore"], theta["ovlp"]
    d = torch.diagonal(h, dim1=-2, dim2=-1)
    f = 0.5 * 1.75 * (d[..., :, None] + d[..., None, :]) * s
    f = (f - torch.diag_embed(torch.diagonal(f, dim1=-2, dim2=-1))
         + torch.diag_embed(d))
    return torch.stack([f, f], dim=-3) if polarized else f


class SCF_QCCalc:
    """Shared SCF calculation; engine supplied by the HF front end."""

    def __init__(self, mol, engine, *, build_theta, opts: SCFOptions,
                 jk_mode: str = "dense"):
        self.mol = mol
        self.engine = engine
        # the J/K route _route chose: dense, df, blocked or stream
        self.jk_mode = jk_mode
        self._build_theta = build_theta   # params -> theta dict
        self.opts = opts
        self._dm = None
        self._energy = None
        self._theta = None
        self._last_jk = None
        self._has_run = False
        # filled by run(): iterations, best residual, residual history,
        # seconds per stage, Fock builds
        self.stats = {}

    def _all_params(self):
        """The differentiable inputs: basis params (atompos among them),
        atomzs, the fields the molecule has and its external potential.
        Unlike the JAX package's, the zero fields are not carried by
        default (forward runs would pay for their multipole integrals);
        api/properties.py adds those it differentiates."""
        mol = self.mol
        p = {"basis": mol.params, "atomzs": mol.atomzs}
        if mol.efield is not None or mol.efield_grad is not None:
            z3 = torch.zeros(3, dtype=mol.dtype, device=mol.device)
            z33 = torch.zeros((3, 3), dtype=mol.dtype, device=mol.device)
            p["efield"] = z3 if mol.efield is None else mol._t(mol.efield)
            p["efield_grad"] = (z33 if mol.efield_grad is None
                                else mol._t(mol.efield_grad))
        if mol.efield_grad2 is not None:
            p["efield_grad2"] = mol._t(mol.efield_grad2)
        if mol.vext is not None:
            p["vext"] = mol._t(mol.vext)
        if getattr(self, "_xc_params", None) is not None:
            p["xc_params"] = self._xc_params
        return p

    # --- the functional core -------------------------------------------
    def _start_fock(self, theta, stats=None):
        """Initial Fock: the core guess (dm0 = 0, so F = hcore) below
        GUESS_NAO; above it F(dm0) of the SAD density, or the GWH Fock for
        guess="gwh", when SAD fails (sad_dm0 raises ValueError: an element
        past the aufbau table or a non-finite atomic density; remembered per
        calc) or when F(dm0) is not finite. Any other error of the atomic
        SCFs (a kernel's build or launch among them) propagates.
        stats (default self.stats): 'guess' says which; 'sad_s' (part of
        scf_s) the seconds of the atomic SCFs. A k-point cell starts from
        the core guess at any size (its engine's zero state), as in the JAX
        package. A stacked theta (parallel/batch.py) gets the start Fock of
        every member: the same atoms in every member, so one SAD density."""
        eng, opts = self.engine, self.opts
        st = self.stats if stats is None else stats
        mol = self.mol
        nao = mol.meta.nao
        kpt = isinstance(eng, KPBCEngine)
        nb = (theta["X"].shape[0]
              if theta["X"].ndim == (4 if kpt else 3) else None)
        lead = () if nb is None else (nb,)
        if kpt:
            st["guess"] = "core"
            return eng.fock(eng.init_dm(mol.device, nb), theta)
        if nao < GUESS_NAO:
            shape = lead + ((2, nao, nao) if eng.polarized else (nao, nao))
            dm0 = torch.zeros(shape, dtype=mol.dtype, device=mol.device)
            st["guess"] = "core"
            return eng.fock(dm0, theta)
        if opts.guess == "sad" and not getattr(self, "_sad_failed", False):
            d0 = getattr(self, "_sad_dm0", None)
            if d0 is None:
                t0 = time.perf_counter()
                try:
                    d0 = sad_dm0(mol)
                except ValueError as ex:   # exotic Z, or a non-finite atom
                    log(f"SAD guess failed ({ex}); using GWH", level=0)
                    self._sad_failed = True
                    st["guess"] = "gwh"
                    return gwh_fock(theta, eng.polarized)
                self._sync()
                self._sad_dm0 = d0   # one set of atomic SCFs per calc
                st.update(
                    sad_s=time.perf_counter() - t0,
                    sad_elements=sorted({ab.atomz for ab in mol.atombases}))
            d0 = d0.expand(lead + (nao, nao)).contiguous()
            if eng.polarized:
                d0 = torch.stack([0.5 * d0, 0.5 * d0], dim=-3)
            f = eng.fock(d0, theta)
            if bool(torch.isfinite(f).all()):
                st["guess"] = "sad"
                return f
            log("SAD initial Fock not finite; using GWH", level=0)
        st["guess"] = "gwh"
        return gwh_fock(theta, eng.polarized)

    def _solver(self, theta, dm0=None):
        """The converged dm of theta: DIIS from the Fock matrix of dm0, or
        from _start_fock without one; the variational solver for
        method="variational"."""
        eng, opts = self.engine, self.opts
        if opts.method == "variational":
            return self._variational_solver(theta, dm0)
        if "jk_facs" in theta:
            return self._stream_solve(theta, dm0)
        f0 = self._start_fock(theta) if dm0 is None else eng.fock(dm0, theta)
        # final answer: the pair-consistent INPUT Fock — dm_from_fock of it
        # reproduces the density whose residual is best_err
        f_star, _, n_iter, best_err, errh = diis_solve(
            self._step_and_err(theta), f0, opts)
        if best_err > opts.tol:
            log(f"DIIS exited above tol (residual {best_err:.3e})", level=0)
        self.stats.update(iterations=n_iter, residual=best_err,
                          residual_history=errh)
        return eng.dm_from_fock(f_star, theta)

    def _variational_solver(self, theta, dm0=None, stats=None):
        """Direct minimisation of the energy over orbital rotations, the JAX
        package's _variational_solver (dqc_tpu/scf/qccalc.py:136-246):
        dm = C occ C^T with the orbitals C(params) of one of three
        parametrisations (opts.orb_param), by BFGS (utils/optimize; max
        |gradient| <= VAR_GTOL or opts.var_maxiter iterations). The start
        orbitals C0 = X U0 are those of the start Fock (_start_fock, as
        the DIIS starts, or F(dm0)):
          matexp: C = C0 expm((K - K^T)/2), K over all (n, n) entries;
          qr: C = X Q, Q R = P with diag(R) > 0 (QR orthonormalises in the
              orthogonal basis), P starting at U0;
          ov: C = C0 expm(K - K^T), K only in the occupied x virtual block
              (nocc * nvirt parameters per spin; integer occupations).
        Never differentiated: solve_dm differentiates its result through
        implicit_fixed_point, as for DIIS. stats (default self.stats):
        iterations (BFGS), var_evaluations, var_status, var_message,
        var_grad_max_abs, and residual, the DIIS error of the result (one
        more Fock build).

        A theta stacked on a member axis (parallel/batch.solve_batch) gets
        the start orbitals and the "ov" blocks per member, and ONE BFGS
        over the stacked parameters of all members that minimises the sum
        of their energies, each evaluation one batched energy (on the dense
        route K1 once for the whole batch). The sum is separable, so its
        minimiser is the members' minimisers, and max |gradient| <=
        VAR_GTOL over the stack is every member's own stop. This departs from
        the JAX package's solver under jax.vmap, which runs a line search
        and a Hessian estimate per member: here the members share them, so
        the iterates differ while each member's result is held to its own
        gradient. residual is then per member."""
        eng, opts = self.engine, self.opts
        st = self.stats if stats is None else stats
        if opts.orb_param not in ORB_PARAMS:
            raise ValueError(f"unknown orb_param {opts.orb_param!r}; "
                             f"one of {ORB_PARAMS}")
        theta = _detached(theta)
        X, occ = theta["X"], theta["occ"]
        batch = X.ndim == 3
        f0 = (self._start_fock(theta, st) if dm0 is None
              else eng.fock(dm0, theta))
        c0, u0 = _start_orbitals(X, theta["keep"], f0)
        xs = X.unsqueeze(-3) if eng.polarized else X

        def rotate(q):
            return torch.einsum("...ij,...jk->...ik", xs, q)
        n = c0.shape[-1]
        shape = tuple(c0.shape)

        def density(c):
            return (c * occ[..., None, :]) @ c.transpose(-1, -2)

        if opts.orb_param == "matexp":
            def dm_of(k):
                k = k.reshape(shape)
                return density(c0 @ torch.linalg.matrix_exp(
                    0.5 * (k - k.transpose(-1, -2))))
            k0 = torch.zeros(c0.numel(), dtype=c0.dtype, device=c0.device)
        elif opts.orb_param == "qr":
            def dm_of(p):
                q, r = torch.linalg.qr(p.reshape(shape))
                s = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
                s = torch.where(s == 0, torch.ones_like(s), s)
                return density(rotate(q * s[..., None, :]))
            k0 = u0.reshape(-1)
        else:
            # one block per matrix of c0 (per member and spin): its rows of
            # occ and of c0 flatten the leading axes alike
            occ2 = occ.reshape(-1, n).cpu().numpy()
            fmax = occ2.max(axis=-1, keepdims=True)
            if not np.all((occ2 == 0) | (occ2 == fmax)):
                raise ValueError(
                    "orb_param='ov' needs integer aufbau occupations; use "
                    "'matexp' for fractional occupations")
            # K's entries, block after block, each block's occupied x
            # virtual entries row-major: their (matrix, row, column) in
            # one scatter, then one batched expm for all matrices
            where = [np.concatenate(t) for t in zip(*(
                (np.full(len(io) * len(iv), b), np.repeat(io, len(iv)),
                 np.tile(iv, len(io)))
                for b, (io, iv) in enumerate(
                    (np.flatnonzero(o > 0), np.flatnonzero(o == 0))
                    for o in occ2)))]
            where = tuple(torch.as_tensor(w, device=c0.device)
                          for w in where)
            c0s = c0.reshape(-1, n, n)

            def dm_of(k):
                pm = torch.zeros(c0s.shape, dtype=k.dtype, device=k.device)
                pm = pm.index_put(where, k)
                return density((c0s @ torch.linalg.matrix_exp(
                    pm - pm.transpose(-1, -2))).reshape(shape))
            k0 = torch.zeros(len(where[0]), dtype=c0.dtype,
                             device=c0.device)
        def fn(k):
            return eng.energy(dm_of(k), theta).sum()

        x, info = minimize_bfgs(fn, k0, opts.var_maxiter, VAR_GTOL)
        dm = dm_of(x)
        err = torch.abs(eng.diis_err(eng.fock(dm, theta), dm, theta))
        err = (torch.amax(err.reshape(shape[0], -1), dim=-1).tolist()
               if batch else float(torch.max(err)))
        st.update(iterations=info["iterations"], residual=err,
                  var_evaluations=info["evaluations"],
                  var_status=info["status"], var_message=info["message"],
                  var_grad_max_abs=info["grad_max_abs"])
        return dm

    def _step_and_err(self, theta, corr=None):
        """fock -> (F(dm(fock)), DIIS error) on theta; `corr` = (dJ, dK) is
        added to J and K (the frozen exact-minus-RI correction of the
        dual-level phase)."""
        eng = self.engine

        def step_and_err(fock):
            dm = eng.dm_from_fock(fock, theta)
            j, k = eng.jk_parts(dm, theta)
            if corr is not None:
                j = j + corr[0]
                k = None if k is None else k + corr[1]
            f_new = eng.fock_from_parts(dm, j, k, theta)
            return f_new, eng.diis_err(f_new, dm, theta)
        return step_and_err

    def _stream_solve(self, theta, dm0=None):
        """SCF of the streamed route: _stream_solve_batch on a batch of
        one, its per-member records unwrapped into self.stats and
        self._last_jk (whose dm is the one returned: run() takes its J and
        K for the energy)."""
        st = {}
        self._stream_solve_batch(
            tree_batch_of_one(theta), None if dm0 is None else dm0[None],
            st)
        self._last_jk = self._last_jk[0]
        for key in ("iterations", "residual", "ri_iterations",
                    "dual_inner_iterations", "exact_jk"):
            st[key] = st[key][0]
        st["residual_history"] = torch.as_tensor(st["residual_history"][0])
        self.stats.update(st)
        return self._last_jk[0]

    def _stream_solve_batch(self, theta, dm0=None, stats=None):
        """SCF of the streamed route for a theta stacked on a member axis
        (parallel/batch.py; _stream_solve runs a batch of one), the JAX
        package's f64 RI phase and dual-level polish
        (dqc_tpu/scf/qccalc.py:674-686, :704-761): batched DIIS on the RI
        fits theta['warm_df'] (tol max(tol, 1e-6), 25 iterations, patience
        4) from the start Fock of that fit (the JAX package's takes one
        exact build for it); then outer cycles, each one exact streamed
        J/K build per member that has not stopped (its own factors,
        jk_matrices), one batched Fock build of those members, their
        residuals measured, and an inner batched DIIS of the members still
        running on the RI map plus each one's frozen correction (exact - RI
        at that density; tol max(tol/10, 1e-13), 20 iterations, patience
        4). A member stops at tol, or when its exact residual is above 0.25
        times its best one (stagnation), after at most 8 outer cycles, and
        is then frozen. Returns the members' best exact iterates' dm,
        stacked; self._last_jk gets each member's (dm, J, K) of that
        iterate, for run()'s energy. stats (default self.stats), per
        member: ri_iterations, dual_inner_iterations, exact_jk ({'builds',
        'seconds', 'residuals'}), iterations (all Fock builds), residual
        (the best exact one); and residual_history, the RI phase's."""
        eng, opts = self.engine, self.opts
        st = self.stats if stats is None else stats
        theta_ri = {k: v for k, v in theta.items() if k != "jk_facs"}
        theta_ri["df"] = theta["warm_df"]
        f = (self._start_fock(theta_ri, st) if dm0 is None
             else eng.fock(dm0, theta_ri))
        ri_opts = opts._replace(tol=max(opts.tol, 1e-6), maxiter=25,
                                diis_patience=4)
        f, _, n_ri, _, errh = diis_solve_batch(self._step_and_err(theta_ri),
                                               f, ri_opts)
        inner_opts = opts._replace(tol=max(opts.tol * 0.1, 1e-13),
                                   maxiter=20, diis_patience=4)
        nb = f.shape[0]
        best = [(float("inf"), None, None, None)] * nb
        exact = [{"builds": 0, "seconds": [], "residuals": []}
                 for _ in range(nb)]
        inner = [[] for _ in range(nb)]
        running = list(range(nb))
        for _ in range(8):
            if not running:
                break
            whole = len(running) == nb
            th = theta if whole else tree_member(theta, running)
            dm = eng.dm_from_fock(f if whole else f[running], th)
            parts = []
            for i, m in enumerate(running):
                t0 = time.perf_counter()
                parts.append(eng.jk_parts(dm[i], tree_member(th, i)))
                self._sync()
                exact[m]["builds"] += 1
                exact[m]["seconds"].append(time.perf_counter() - t0)
            j_ex = torch.stack([p[0] for p in parts])
            k_ex = (None if parts[0][1] is None
                    else torch.stack([p[1] for p in parts]))
            f_new = eng.fock_from_parts(dm, j_ex, k_ex, th)
            e = eng.diis_err(f_new, dm, th)
            errs = torch.amax(torch.abs(e).reshape(len(running), -1),
                              dim=-1).tolist()
            go = []
            for i, m in enumerate(running):
                err = errs[i]
                exact[m]["residuals"].append(err)
                if not err == err or err == float("inf"):
                    log(f"stream SCF, member {m}: non-finite exact "
                        "residual; returning its best outer iterate",
                        level=0)
                    if best[m][1] is None:
                        best[m] = (err, dm[i], parts[i][0], parts[i][1])
                    continue
                stalled = err > 0.25 * best[m][0]
                if err < best[m][0]:
                    best[m] = (err, dm[i], parts[i][0], parts[i][1])
                if not (err < opts.tol or stalled):
                    go.append(i)
            if go:
                th_ri = {k: v for k, v in tree_member(th, go).items()
                         if k != "jk_facs"}
                th_ri["df"] = th_ri["warm_df"]
                dm_go = dm[go]
                j_ri, k_ri = eng.jk_parts(dm_go, th_ri)
                corr = (j_ex[go] - j_ri,
                        None if k_ex is None else k_ex[go] - k_ri)
                f_in, _, n_in, _, _ = diis_solve_batch(
                    self._step_and_err(th_ri, corr), f_new[go], inner_opts)
                f = f.clone()
                for i, row in zip(go, f_in):
                    f[running[i]] = row
                for i, n in zip(go, n_in):
                    inner[running[i]].append(n)
            running = [running[i] for i in go]
        errs = [b[0] for b in best]
        bad = [e for e in errs if not e <= opts.tol]
        if bad:
            log(f"stream SCF: {len(bad)} of {nb} member(s) exited above tol "
                f"(worst residual {max(bad):.3e})", level=0)
        self._last_jk = [(b[1], b[2], b[3]) for b in best]
        st.update(iterations=[n_ri[m] + sum(inner[m]) + exact[m]["builds"]
                              for m in range(nb)],
                  residual=errs, residual_history=errh,
                  ri_iterations=n_ri, dual_inner_iterations=inner,
                  exact_jk=exact)
        return torch.stack([b[1] for b in best])

    def _sync(self):
        if self.mol.device.type == "cuda":
            torch.cuda.synchronize(self.mol.device)

    def _theta_cache(self):
        """The on-disk cache of the system's theta (Mol/Sol.set_cache), or
        None. Only run() reads it: a cached tensor has no graph, so every
        derivative (solve_dm, energy_fn, energy_grad, energy_batch)
        rebuilds theta from the params."""
        mol = self.mol
        fname = getattr(mol, "_cache_fname", None)
        if fname is None:
            return None
        return Cache(fname, signature=mol.cache_signature,
                     paramnames=mol._cache_paramnames, device=mol.device,
                     fingerprint=getattr(mol, "cache_fingerprint", ""))

    # --- user API --------------------------------------------------------
    def run(self):
        with torch.no_grad():
            t0 = time.perf_counter()
            theta = self._theta
            if theta is None:
                theta = self._build_theta(self._all_params(),
                                          stats=self.stats,
                                          cache=self._theta_cache())
            self._sync()
            t1 = time.perf_counter()
            self._last_jk = None
            self._dm = self._solver(theta)
            self._sync()
            t2 = time.perf_counter()
            last = self._last_jk
            if last is not None and last[0] is self._dm:
                # the streamed route's exact J/K at this dm are in hand
                self._energy = self.engine.energy_from_parts(
                    self._dm, last[1], last[2], theta)
            else:
                self._energy = self.engine.energy(self._dm, theta)
            self._sync()
            self.stats.update(theta_s=t1 - t0, scf_s=t2 - t1,
                              energy_s=time.perf_counter() - t2)
        self._theta = theta
        self._has_run = True
        return self

    def energy(self):
        assert self._has_run, "call .run() first"
        return self._energy

    def aodm(self):
        """The converged density matrix: (nao, nao), or SpinParam of two;
        for a k-point cell the complex D^k (nk, nao, nao) per spin."""
        assert self._has_run, "call .run() first"
        dm = self._dm
        if isinstance(self.engine, KPBCEngine):
            dm = join(dm)
        if self.engine.polarized:
            return SpinParam(u=dm[0], d=dm[1])
        return dm

    def dm2energy(self, dm):
        if isinstance(dm, SpinParam):
            dm = torch.stack([dm.u, dm.d], dim=0)
        if dm.is_complex():
            dm = torch.stack([dm.real, dm.imag])
        if self._theta is None:
            self._theta = self._build_theta(self._all_params())
        return self.engine.energy(dm, self._theta)

    def dm2dens(self, coords, dm=None):
        """Electron density at points coords (nr, 3), in Bohr, on the
        molecule's device: (nr,) for a restricted dm, SpinParam of the up
        and down densities for a polarized one; dm defaults to the
        converged density (the JAX package's dm2dens,
        dqc_tpu/scf/qccalc.py:1278-1296)."""
        if dm is None:
            assert self._has_run, "call .run() first or pass dm"
            dm = self._dm
        if isinstance(dm, SpinParam):
            dm = torch.stack([dm.u, dm.d], dim=0)
        mol = self.mol
        tabs = eval_ao(mol.meta, self._all_params()["basis"], mol._t(coords))
        pol = dm.ndim == 3
        dens = density_from_tables(tabs, dm, family=1, polarized=pol)
        if pol:
            return SpinParam(u=dens["u"]["rho"], d=dens["d"]["rho"])
        return dens["rho"]

    # --- derivatives -----------------------------------------------------
    def solve_dm(self, params):
        """params -> (converged dm, theta), differentiable in params to
        any order: theta is built in the graph and dm is the implicit
        fixed point of engine.step, started from the dm of run() when
        there is one. GMRES records of the backward go to
        stats['gmres']."""
        theta = self._build_theta(params)
        dm0 = None if self._dm is None else self._dm.detach()
        dm = implicit_fixed_point(
            self.engine.step, lambda th, x0: self._solver(th, x0), theta,
            dm0, stats=self.stats.setdefault("gmres", []))
        return dm, theta

    def energy_fn(self, params):
        """params -> total energy, with exact derivatives through the SCF."""
        dm, theta = self.solve_dm(params)
        return self.engine.energy(dm, theta)

    def _leaves(self, params, wrt=None):
        """params with floating tensors replaced by detached copies that
        require grad, and the list of those copies: every floating tensor,
        or with `wrt` (key paths such as ("efield",) or ("basis",
        "atompos")) only those under one of the paths, the rest left as
        they are. A property that differentiates the fields alone so
        builds no cotangent of the basis parameters or of the ERI
        tensors."""
        leaves = []
        wrt = None if wrt is None else [tuple(w) for w in wrt]

        def take(t, path):
            if isinstance(t, dict):
                return {k: take(v, path + (k,)) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(take(v, path) for v in t)
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and (wrt is None
                         or any(path[:len(w)] == w for w in wrt))):
                leaves.append(t.detach().requires_grad_(True))
                return leaves[-1]
            return t
        out = take(params, ())
        del take     # a self-referencing closure: no cycle holds leaves
        return out, leaves

    def _like(self, params, values):
        """The structure of params with its floating tensors replaced, in
        order, by `values` (None -> zeros)."""
        it = iter(values)

        def put(t):
            if isinstance(t, dict):
                return {k: put(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(put(v) for v in t)
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                g = next(it)
                return torch.zeros_like(t) if g is None else g
            return t
        out = put(params)
        del put      # a self-referencing closure: no cycle holds values
        return out

    def energy_grad(self, params=None):
        """dE/dparams as a dict shaped like params (default
        _all_params()); runs the SCF first if needed.
        Forces: -energy_grad()["basis"]["atompos"]. Seconds (the whole,
        the forward that builds the graph, the backward) and GMRES records
        go to stats ('grad_s', 'grad_forward_s', 'grad_backward_s',
        'gmres')."""
        if not self._has_run:
            self.run()
        if params is None:
            params = self._all_params()
        self.stats["gmres"] = []
        t0 = time.perf_counter()
        with torch.enable_grad():
            p, leaves = self._leaves(params)
            e = self.energy_fn(p)
            self._sync()
            t1 = time.perf_counter()
            grads = torch.autograd.grad(e, leaves, allow_unused=True)
        self._sync()
        t2 = time.perf_counter()
        self.stats.update(grad_s=t2 - t0, grad_forward_s=t1 - t0,
                          grad_backward_s=t2 - t1)
        return self._like(params, grads)

    def energy_hvp(self, v, params=None):
        """(d^2 E/dparams^2) v as a dict shaped like params (default
        _all_params()), by a double backward through energy_fn: v is
        shaped like params, a None in it stands for zeros. The backward of
        the adjoint solve is the transposed solve, so the product is exact
        at the fixed point. GMRES records go to stats['gmres']."""
        if not self._has_run:
            self.run()
        if params is None:
            params = self._all_params()
        vs = _floats(self._like(params, _floats(v)))
        self.stats["gmres"] = []
        with torch.enable_grad():
            p, leaves = self._leaves(params)
            grads = torch.autograd.grad(self.energy_fn(p), leaves,
                                        create_graph=True, allow_unused=True)
            dot = sum((g * d.detach()).sum() for g, d in zip(grads, vs)
                      if g is not None)
            hv = torch.autograd.grad(dot, leaves, allow_unused=True)
        return self._like(params, hv)

    def get_system(self):
        return self.mol


def _floats(tree):
    """The floating tensors of a nested dict/list, in the order _leaves
    takes them (None stays None)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _floats(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _floats(v)]
    if tree is None or (isinstance(tree, torch.Tensor)
                        and tree.is_floating_point()):
        return [tree]
    return []


def _options(variational, opts):
    """The SCF options of HF/KS: variational=True asks for the variational
    solver whatever opts says otherwise."""
    opts = opts or SCFOptions()
    if variational:
        opts = opts._replace(method="variational")
    if opts.method not in ("diis", "variational"):
        raise ValueError(f"unknown SCF method {opts.method!r}; 'diis' or "
                         "'variational'")
    return opts


def _route(mol, opts, n_lr: int = 0):
    """(mode, jk_info) of a molecule: 'df' with densityfit(); else 'dense'
    while its 1 + n_lr dense nao^4 tensors (eri_k and the attenuated ones of
    a range-separated hybrid) fit config.DENSE_ERI_BYTES_LIMIT together;
    else 'blocked' while the canonical quartet blocks of the Schwarz-screened
    pair groups fit config.BLOCKED_JK_BYTES_LIMIT, and 'stream' past it.
    jk_info = (BasisMeta, scf/jk.build_jk_meta groups) on the last two.
    Raises for what the port does not cover yet, and for a range-separated
    hybrid past the dense limit, which the blocked and streamed routes do
    not serve (as in the JAX package, dqc_tpu/scf/qccalc.py:1795-1799)."""
    if opts.guess not in ("sad", "gwh"):
        raise ValueError(f"unknown initial guess {opts.guess!r}")
    if mol.dfinfo is not None:
        return "df", None
    nao = mol.meta.nao
    limit = config.DENSE_ERI_BYTES_LIMIT
    need = (1 + n_lr) * nao ** 4 * 8
    if need <= limit:
        return "dense", None
    if n_lr:
        raise NotImplementedError(
            f"range-separated exchange at nao = {nao} needs {1 + n_lr} dense "
            f"ERI tensors ({need} bytes), above the {limit}-byte limit of "
            "the dense route, and the blocked and streamed routes have no "
            "long-range exchange; call mol.densityfit() for the "
            "density-fitted route")
    jkm = build_jk_meta(mol.meta, _screened(mol))
    mode = ("blocked" if jk_blocks_nbytes(jkm) <= config.BLOCKED_JK_BYTES_LIMIT
            else "stream")
    return mode, (mol.meta, jkm)


def _df_setup(mol):
    """(meta_aux, params_aux) of the molecule's aux basis on its device, or
    None without densityfit()."""
    if mol.dfinfo is None:
        return None
    return pack_basis(mol.dfinfo.auxbases, device=mol.device)


def _warm_df_setup(mol):
    """(meta_aux, params_aux) of the autoaux basis whose RI fit steers the
    streamed route's SCF (the JAX package's _warm_df_setup)."""
    return pack_basis(autoaux(mol.atombases), device=mol.device)


def _df_fit(mol, params, dfset, omega=None):
    """build_df_theta with the aux centres tied to the (traced) atom
    positions, so that derivatives see them."""
    meta_aux, params_aux = dfset
    pa = dict(params_aux, atompos=params["basis"]["atompos"])
    return build_df_theta(mol.meta, params["basis"], meta_aux, pa,
                          omega=omega)


def _make_theta(mol, params, occ, stats, grid=None, family=None,
                 omegas=(), dfset=None, mode="dense", jk_info=None,
                 warm=None, cache=None):
    """theta of a route (`mode`, from _route): one-electron integrals and
    occupations (hcore with the external potential of params['vext']);
    eri_k (dense), the fit df (DF), the weighted canonical
    blocks jkb0, jkb1, ... of scf/jk.py (blocked), or the pair groups'
    Hermite factors jk_facs and the RI fit warm_df in the autoaux basis
    `warm`, built without a graph (stream); for KS the grid tables and the
    xc_params; and per omega an erf-attenuated eri_lr_k{i} (dense) or its
    fit df_lr{i} (DF). Each nao^4 tensor is built, laid out and its
    J-layout intermediate freed before the next build starts.

    theta is built in the JAX package's named parts (its _theta_parts):
    "core" (the one-electron integrals, hcore with vext, and eri_k on the
    dense route), "df", "jkb{i}", "jk" and "warmdf", "grid", "erilr{i}" and
    "dflr{i}". With a `cache` (utils/cache.Cache; run() of a molecule after
    set_cache) each part the cache takes is loaded from its file when it is
    there and stored after it is built; stats['theta_cached'] lists the
    parts loaded. `stats` gets jk_mode and the seconds of the stages built:
    int1e_s; eri_s and eri_lr_s (dense); df_s with its split coul2c_s,
    coul3c_s, factor_s, naux and metric_ratio, and df_lr_s with the
    per-omega records df_lr (DF); jk_blocks_s (blocked) or jk_facs_s,
    warm_df_s and warm_naux (stream), with jk_blocks_bytes and jk_combos
    (both); grid_s."""
    dev = mol.device
    times = {"jk_mode": mode}
    loaded = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def part(name, build, key=None):
        """The entries of part `name`: the cache's, or build() timed under
        `key` (and stored where the cache takes the part)."""
        if cache is not None and cache.has_tree(name):
            loaded.append(name)
            return cache.cache_tree(name, build)
        t = time.perf_counter()
        out = (build() if cache is None
               else cache.cache_tree(name, build, flush=False))
        sync()
        if key is not None:
            times[key] = time.perf_counter() - t
        return out

    def exchange_layout(omega=None):
        eri = eri_dense(mol.meta, params["basis"], screened=scr, omega=omega)
        out = eri.permute(0, 2, 1, 3).contiguous()
        del eri
        return out

    scr = _screened(mol) if mode == "dense" else None

    def core():
        t0 = time.perf_counter()
        th = build_core_theta(mol.meta, params["basis"], params["atomzs"],
                              efield=params.get("efield"),
                              efield_grad=params.get("efield_grad"),
                              efield_grad2=params.get("efield_grad2"),
                              with_eri=False)
        if "vext" in params:
            # the external potential on the molecule's grid (built on first
            # use for HF), as in the JAX package's HF and KS part_core
            th["hcore"] = th["hcore"] + vext_matrix(
                mol.meta, params["basis"], mol.setup_grid(), params["vext"])
        sync()
        t1 = time.perf_counter()
        times["int1e_s"] = t1 - t0
        if mode == "dense":
            th["eri_k"] = exchange_layout()
            sync()
            times["eri_s"] = time.perf_counter() - t1
        return th

    theta = part("core", core)
    if mode == "df":
        def fit():
            th, info = _df_fit(mol, params, dfset)
            times.update(info)
            return {"df": th}
        theta.update(part("df", fit, "df_s"))
    elif mode in ("blocked", "stream"):
        bmeta, jkm = jk_info
        times.update(jk_blocks_bytes=jk_blocks_nbytes(jkm),
                     jk_combos=len(jk_combos(jkm)))
        if mode == "blocked":
            names = [f"jkb{ci}" for ci in range(len(jk_combos(jkm)))]
            if cache is not None and all(cache.has_tree(n) for n in names):
                for n in names:
                    theta.update(part(n, None))
            else:
                t1 = time.perf_counter()
                for n, blk in zip(names, build_jk_blocks(
                        bmeta, params["basis"], jkm)):
                    d = {n: blk}
                    theta.update(d if cache is None else cache.cache_tree(
                        n, lambda d=d: d, flush=False))
                sync()
                times["jk_blocks_s"] = time.perf_counter() - t1
        else:
            theta.update(part("jk", lambda: {"jk_facs": factors_to_theta(
                build_jk_factors(bmeta, params["basis"], jkm))},
                "jk_facs_s"))

            def warm_fit():
                # the fit only steers the solver (_stream_solve): no graph
                with torch.no_grad():
                    th, info = _df_fit(mol, params, warm)
                times["warm_naux"] = info["naux"]
                return {"warm_df": th}
            theta.update(part("warmdf", warm_fit, "warm_df_s"))
    theta["occ"] = occ
    if grid is not None:
        theta.update(part("grid", lambda: {"grid": setup_grid_theta(
            mol.meta, params["basis"], grid, family=family)}, "grid_s"))
        theta["xc_params"] = params.get("xc_params")
    lr_info = []
    t3 = time.perf_counter()
    for i, w in enumerate(omegas):
        if mode == "dense":
            th = part(f"erilr{i}",
                      lambda w=w: {f"eri_lr_k{i}": exchange_layout(omega=w)})
            # K1 counts its launches on these tensors under this tag
            th[f"eri_lr_k{i}"].jk_tag = "eri_lr"
        else:
            def lr_fit(i=i, w=w):
                th, info = _df_fit(mol, params, dfset, omega=w)
                lr_info.append(dict(info, omega=w))
                return {f"df_lr{i}": th}
            th = part(f"dflr{i}", lr_fit)
        theta.update(th)
    if omegas:
        times["eri_lr_s" if mode == "dense" else "df_lr_s"] = \
            time.perf_counter() - t3
        if mode != "dense":
            times["df_lr"] = lr_info
    if cache is not None:
        times["theta_cached"] = loaded
        cache.flush()
    if stats is not None:
        stats.update(times)
    log("theta built: " + ", ".join(f"{k} {v:.2f}s" for k, v in times.items()
                                    if k.endswith("_s")))
    return theta


def _whole_theta(build, params, stats, cache):
    """A cell's theta, build(params, stats), as the one part "all" that the
    JAX package caches for a calc without named parts: loaded from the
    cache where it holds it, else built (and stored where the cache takes
    it). xc_params always come from params, never from the file."""
    if cache is None:
        return build(params, stats)
    loaded = cache.has_tree("all")

    def fn():
        th = build(params, stats)
        th.pop("xc_params", None)
        return th
    theta = dict(cache.cache_tree("all", fn))
    theta["xc_params"] = params.get("xc_params")
    if stats is not None:
        stats["theta_cached"] = ["all"] if loaded else []
    return theta


def _pbc_calc(sol, xc, restricted, opts) -> SCF_QCCalc:
    """Gamma-point HF (xc None) or KS of a periodic cell, the JAX package's
    _pbc_hf and _pbc_ks (dqc_tpu/scf/qccalc.py:1652-1716): J and K from the
    pair transforms (route "aft") or the periodic fit (route "gdf"); the
    Madelung correction of exact exchange for opts.exxdiv "ewald" (None:
    none), computed only when the method has exact exchange; KS adds the
    cell-wrapped grid tables. stats: the stage seconds of
    build_pbc_core_theta, grid_s with becke_s and ao_tables_s. A cell with
    k-points takes _kpbc_calc."""
    if opts.exxdiv not in ("ewald", None):
        raise ValueError(f"unknown exxdiv {opts.exxdiv!r}; 'ewald' or None")
    if has_kpoints(sol.kpts):
        return _kpbc_calc(sol, xc, restricted, opts)
    polarized = sol.polarized if restricted is None else (not restricted)
    occ = _occ_array(sol, polarized)
    omegas = () if xc is None else tuple(w for _, w in xc.exx_lr)
    needs_k = xc is None or xc.exx_fraction != 0.0 or bool(omegas)
    mad = (madelung_constant(sol.lattice)
           if needs_k and opts.exxdiv == "ewald" else None)
    gdfset = _df_setup(sol)
    if xc is not None:
        grid = sol.setup_grid()
        ls_ao = sol.lattice.get_lattice_ls(
            estimate_rcut(sol.meta, sol.params, AO_PRECISION))

    def build(params, stats=None):
        dev = sol.device
        times = {"jk_mode": "aft" if gdfset is None else "gdf"}
        gdf_aux = None
        if gdfset is not None:
            gdf_aux = (gdfset[0], dict(gdfset[1],
                                       atompos=params["basis"]["atompos"]))
        theta = build_pbc_core_theta(
            sol, params["basis"], params["atomzs"],
            precision=CORE_PRECISION, madelung=mad, gdf_aux=gdf_aux,
            lr_omegas=omegas, stats=times)
        theta["occ"] = occ
        if xc is not None:
            t0 = time.perf_counter()
            theta["grid"] = setup_pbc_grid_theta(
                sol.meta, params["basis"], grid, ls_ao, family=xc.family,
                stats=times)
            theta["xc_params"] = params.get("xc_params")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times["grid_s"] = time.perf_counter() - t0
        if stats is not None:
            stats.update(times)
        return theta

    def build_theta(params, stats=None, cache=None):
        return _whole_theta(build, params, stats, cache)

    engine = (HFEngine(polarized=polarized) if xc is None
              else KSEngine(xc, polarized=polarized))
    calc = SCF_QCCalc(sol, engine, build_theta=build_theta, opts=opts,
                      jk_mode="aft" if gdfset is None else "gdf")
    if isinstance(xc, CustomXC):
        calc._xc_params = {xc.key: xc.init_params}
    return calc


def _kpbc_calc(sol, xc, restricted, opts) -> SCF_QCCalc:
    """HF (xc None: the pure exchange functional "hf") or KS of a cell with
    k-points, the JAX package's _kpbc_ks (dqc_tpu/scf/qccalc.py:1619-1649)
    on scf/kpbc.py: J from the Bloch pair transforms (route "aft") or the
    k-point fit (route "gdf"), exact exchange from the mixed (k, k') stack
    with the Madelung term of the mesh's Born-von-Karman supercell for
    opts.exxdiv "ewald", XC through K2/K3 on the embedded Bloch tables. The
    SCF starts from the core guess. stats: int1e_s, pair_ft_s, vnuc_s,
    exx_s, gdf_s, grid_s with becke_s and ao_tables_s, nk, n_gvectors,
    n_pair_terms."""
    if opts.method != "diis":
        raise ValueError("a k-point cell has the DIIS solver only "
                         f"(method {opts.method!r})")
    xc = get_xc("hf") if xc is None else xc
    polarized = sol.polarized if restricted is None else (not restricted)
    occ = _occ_array(sol, polarized)
    engine = KPBCEngine(xc, nk=len(sol.kpts), nao=sol.meta.nao,
                        polarized=polarized)
    omegas = tuple(w for _, w in engine.exx_lr)
    mad = (madelung_constant(kmesh_supercell(sol.lattice, sol.kpts))
           if engine.has_exx and opts.exxdiv == "ewald" else None)
    gdfset = _df_setup(sol)
    ls_ao = (sol.lattice.get_lattice_ls(estimate_rcut(
        sol.meta, sol.params, AO_PRECISION)) if engine.semilocal
        else None)

    def build(params, stats=None):
        gdf_aux = None
        if gdfset is not None:
            gdf_aux = (gdfset[0], dict(gdfset[1],
                                       atompos=params["basis"]["atompos"]))
        times = {"jk_mode": "aft" if gdfset is None else "gdf"}
        theta = build_kpbc_theta(
            sol, params["basis"], params["atomzs"],
            semilocal=engine.semilocal, family=xc.family,
            with_exx=engine.has_exx, madelung=mad, lr_omegas=omegas,
            gdf_aux=gdf_aux, ls_ao=ls_ao, stats=times)
        theta["occ"] = occ
        theta["xc_params"] = params.get("xc_params")
        if stats is not None:
            stats.update(times)
        return theta

    def build_theta(params, stats=None, cache=None):
        return _whole_theta(build, params, stats, cache)

    calc = SCF_QCCalc(sol, engine, build_theta=build_theta, opts=opts,
                      jk_mode="aft" if gdfset is None else "gdf")
    if isinstance(xc, CustomXC):
        calc._xc_params = {xc.key: xc.init_params}
    return calc


def HF(mol, *, restricted: Optional[bool] = None, variational: bool = False,
       opts: Optional[SCFOptions] = None) -> SCF_QCCalc:
    """Hartree-Fock front end.

    A molecule without densityfit() takes the dense route while its ERI
    fits config.DENSE_ERI_BYTES_LIMIT: eri = eri_dense(...) and theta
    carries its exchange layout eri_k = eri.permute(0,2,1,3), the tensor the
    JAX package reaches through its blocked route at benzene size (its byte
    limits are sized for a 16 GB chip). Past that limit it takes the
    blocked route (the canonical quartet blocks cached in theta) while they
    fit config.BLOCKED_JK_BYTES_LIMIT, and the streamed route past that
    (_route, scf/jk.py). A molecule with densityfit() takes the DF route:
    RI-J and RI-K from the fit of scf/df.py, no nao^4 tensor, no size
    limit. A periodic cell (Sol) runs at the Gamma point (_pbc_calc), or
    with k-points on the k-point engine (_kpbc_calc)."""
    opts = _options(variational, opts)
    if hasattr(mol, "lattice"):
        return _pbc_calc(mol, None, restricted, opts)
    mode, jk_info = _route(mol, opts)
    polarized = mol.polarized if restricted is None else (not restricted)
    occ = _occ_array(mol, polarized)
    dfset = _df_setup(mol)
    warm = _warm_df_setup(mol) if mode == "stream" else None

    def build_theta(params, stats=None, cache=None):
        return _make_theta(mol, params, occ, stats, dfset=dfset, mode=mode,
                           jk_info=jk_info, warm=warm, cache=cache)

    return SCF_QCCalc(mol, HFEngine(polarized=polarized, jk_info=jk_info),
                      build_theta=build_theta, opts=opts, jk_mode=mode)


def KS(mol, xc="lda_x", *, restricted: Optional[bool] = None,
       variational: bool = False,
       opts: Optional[SCFOptions] = None) -> SCF_QCCalc:
    """Kohn-Sham front end: LDA, GGA and meta-GGA functionals, hybrids
    (B3LYP, PBE0, TPSSh, ...), range-separated hybrids (CAM-B3LYP, LC-BLYP,
    lr_hf(omega) expressions) and CustomXC functionals, restricted or
    polarized, on HF's routes (dense, blocked, streamed, or density-fitted
    after mol.densityfit()) plus the grid tables of mol.setup_grid(). On the
    card every Fock build of the dense route runs K1 for J and K (and once
    more per omega for the long-range K); the blocked and streamed routes
    contract the quartet blocks (J only for a functional without exact
    exchange) and launch K1 only in the atoms of the SAD start; the DF
    route computes RI-J, RI-K when the functional has exact exchange, and
    RI-K on each omega's attenuated-metric fit. A range-separated hybrid
    whose dense tensors do not fit the dense limit raises, naming
    mol.densityfit(). Every route runs K2/K3 for the density and V_xc of a
    GGA or meta-GGA. A CustomXC's parameters are differentiable inputs:
    energy_grad()['xc_params']. A periodic cell (Sol) runs at the Gamma
    point (_pbc_calc), K2/K3 on its lattice-summed grid tables, or with
    k-points (_kpbc_calc), K2/K3 once per k and spin on the real embedding
    of its Bloch tables."""
    xc = get_xc(xc)
    opts = _options(variational, opts)
    if hasattr(mol, "lattice"):
        return _pbc_calc(mol, xc, restricted, opts)
    mode, jk_info = _route(mol, opts, n_lr=len(xc.exx_lr))
    polarized = mol.polarized if restricted is None else (not restricted)
    occ = _occ_array(mol, polarized)
    grid = mol.setup_grid()
    omegas = tuple(w for _, w in xc.exx_lr)
    dfset = _df_setup(mol)
    warm = _warm_df_setup(mol) if mode == "stream" else None

    def build_theta(params, stats=None, cache=None):
        return _make_theta(mol, params, occ, stats, grid=grid,
                           family=xc.family, omegas=omegas, dfset=dfset,
                           mode=mode, jk_info=jk_info, warm=warm, cache=cache)

    calc = SCF_QCCalc(mol, KSEngine(xc, polarized=polarized,
                                    jk_info=jk_info),
                      build_theta=build_theta, opts=opts, jk_mode=mode)
    # the NN parameters of a CustomXC are differentiable inputs
    if isinstance(xc, CustomXC):
        calc._xc_params = {xc.key: xc.init_params}
    return calc


# aufbau shell order (l, degeneracy) of the SAD occupations, through 5p
_SAD_AUFBAU = [(0, 1), (0, 1), (1, 3), (0, 1), (1, 3), (0, 1), (2, 5),
               (1, 3), (0, 1), (2, 5), (1, 3)]


def _sad_occ(z: int, nao: int):
    """Spherically averaged aufbau occupations of a neutral atom over nao
    orbitals: each (sub)shell's electrons spread evenly over its degenerate
    orbitals, so the atomic density is rotation-invariant."""
    w = []
    rem = float(z)
    for _, deg in _SAD_AUFBAU:
        if rem <= 0 or len(w) >= nao:
            break
        take = min(rem, 2.0 * deg)
        w += [take / deg] * deg
        rem -= take
    if rem > 1e-9:
        raise ValueError(f"SAD aufbau table too short for Z={z}")
    return w[:nao] + [0.0] * (nao - len(w))


def sad_dm0(mol, xc="lda_x"):
    """Superposition-of-atomic-densities density matrix (nao, nao) on the
    molecule's device. Each unique (element, basis) runs one small
    spin-averaged, fractionally occupied atomic KS-LDA in the molecule's
    basis (grid level 1, from the core guess); the atomic densities are
    assembled block-diagonally (the AO blocks are contiguous per atom in
    pack_basis order)."""
    from ..system.mol import Mol
    cache = {}
    nao = mol.meta.nao
    dm = torch.zeros((nao, nao), dtype=mol.dtype, device=mol.device)
    off = 0
    for ab in mol.atombases:
        na = sum(nsph(b.angmom) for b in ab.bases)
        key = (int(ab.atomz),
               tuple((b.angmom, tuple(map(float, np.asarray(b.alphas))))
                     for b in ab.bases))
        if key not in cache:
            z = int(ab.atomz)
            amol = Mol((np.array([float(z)]), np.zeros((1, 3))),
                       basis={z: list(ab.bases)}, spin=0,
                       orb_weights=_sad_occ(z, na), grid=1,
                       device=mol.device)
            qa = KS(amol, xc=xc,
                    opts=SCFOptions(mixed=False, guess="gwh")).run()
            dm_a = qa.aodm()
            if not bool(torch.isfinite(dm_a).all()):
                raise ValueError(
                    f"SAD atomic SCF for Z={z} gave a non-finite density")
            cache[key] = dm_a
        dm[off:off + na, off:off + na] = cache[key]
        off += na
    return dm
