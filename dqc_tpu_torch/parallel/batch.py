"""A batch of geometries of one molecule through one SCF: the port's batch
axis.

Counterpart of the `dp` axis of dqc_tpu/parallel/mesh.py (the batch of
molecules that neural-XC training maps over), which the JAX package runs
as jax.vmap(calc.energy_fn): vmap batches each pallas_call along a new grid
axis and each while_loop per member. PyTorch has no vmap of a Python SCF
loop with a host sync per iteration, so the batch is written out here:

  - theta: each member's integrals, eri_k (or its fit) and its moving
    Becke grid, built by the calc's own _build_theta from the member's
    params and stacked on a leading axis (the grid has the same points for
    every member, the molecule's grid spec);
  - the engine's products carry the axis (scf/engine.py, xc/integrate.py),
    and K1-K3 take it in ONE launch each per Fock build;
  - the solver is scf/fixed_point.diis_solve_batch: a DIIS history, best
    iterate and patience per member, one host sync per iteration for the
    whole batch, a stopped member frozen as the vmapped while_loop freezes
    it;
  - the derivative is the same implicit_fixed_point: the batched step map
    is block-diagonal in the members, and its adjoint is solved by GMRES
    over the stacked vector, one batched matvec (one launch of each
    kernel's backward) per Krylov step. A block-diagonal system solved as
    one is exact, and the members share their spectrum's shape (one
    molecule at nearby geometries), so the Krylov space of the stack is
    not much larger than a member's; derivatives to any order stay those
    of _LinSolve.

On one card the mesh's other axes have no counterpart (PERF.md §6): `grid`
and `tp` shard the grid points and the fit's aux axis over TPU chips, and
jk_from_blocks' mesh sharding spreads the quartet blocks over them.

Routes: dense and density-fitted. A blocked, streamed or periodic calc
raises (ROADMAP A16).
"""
from __future__ import annotations

import time

import torch

from ..scf import qccalc
from ..scf.fixed_point import diis_solve_batch, implicit_fixed_point
from ..scf.kpbc import KPBCEngine
from ..utils.datastruct import batch_size, member_params
from ..utils.logger import log

ROUTES = ("dense", "df")


def _check_calc(calc):
    if isinstance(calc.engine, KPBCEngine) or hasattr(calc.mol, "lattice"):
        raise NotImplementedError(
            "a batch of periodic cells is not ported (ROADMAP A16)")
    if calc.jk_mode not in ROUTES:
        raise NotImplementedError(
            f"a batch on the {calc.jk_mode!r} J/K route is not ported "
            "(ROADMAP A16): the dense and density-fitted routes take a batch")
    if calc.opts.method != "diis":
        raise NotImplementedError(
            f"a batch runs the DIIS solver only (method {calc.opts.method!r})")


def _stack_into(out, th, m, nb):
    """Member m's theta th into the stacked dict out (allocated at m = 0):
    tensors into their slot of a (nb, ...) tensor, anything else kept from
    member 0."""
    for k, v in th.items():
        if isinstance(v, dict):
            _stack_into(out.setdefault(k, {}), v, m, nb)
        elif isinstance(v, torch.Tensor):
            if m == 0:
                out[k] = v.new_empty((nb,) + tuple(v.shape))
                tag = getattr(v, "jk_tag", None)
                if tag is not None:
                    out[k].jk_tag = tag
            out[k][m] = v
        elif m == 0:
            out[k] = v


def build_theta_batch(calc, params_b, stats=None):
    """theta of every member of a batched params tree (datastruct.
    batch_params), stacked (nb, ...); xc_params stay the shared tree.
    Each member's theta is built, copied into the stack and dropped before
    the next one starts. Differentiable in the params as the calc's own
    build is (the stack's copies carry the graph)."""
    _check_calc(calc)
    nb = batch_size(params_b)
    t0 = time.perf_counter()
    out = {}
    for m in range(nb):
        th = calc._build_theta(member_params(params_b, m))
        th.pop("xc_params", None)
        _stack_into(out, th, m, nb)
        del th
    out["xc_params"] = params_b.get("xc_params")
    calc._sync()
    if stats is not None:
        stats.update(batch=nb, theta_s=time.perf_counter() - t0)
    return out


def start_fock_batch(calc, theta_b):
    """The start Fock matrices of a batch: the core guess below GUESS_NAO,
    else F(dm0) of the molecule's SAD density (the same atoms in every
    member), or the GWH Fock where SAD fails, as SCF_QCCalc._start_fock."""
    eng, mol = calc.engine, calc.mol
    nb = theta_b["hcore"].shape[0]
    nao = mol.meta.nao
    if nao < qccalc.GUESS_NAO:
        shape = (nb, 2, nao, nao) if eng.polarized else (nb, nao, nao)
        return eng.fock(torch.zeros(shape, dtype=mol.dtype,
                                    device=mol.device), theta_b)
    if calc.opts.guess == "sad":
        d0 = getattr(calc, "_sad_dm0", None)
        try:
            d0 = qccalc.sad_dm0(mol) if d0 is None else d0
        except ValueError as ex:
            log(f"SAD guess failed ({ex}); using GWH", level=0)
        else:
            calc._sad_dm0 = d0
            d0 = d0.expand(nb, nao, nao)
            if eng.polarized:
                d0 = torch.stack([0.5 * d0, 0.5 * d0], dim=-3)
            f = eng.fock(d0.contiguous(), theta_b)
            if bool(torch.isfinite(f).all()):
                return f
    return qccalc.gwh_fock(theta_b, eng.polarized)


def solve_batch(calc, theta_b, dm0=None, stats=None):
    """The converged density matrices (nb, [2,] nao, nao) of a stacked
    theta: batched DIIS from F(dm0), or from the start Fock without one.
    stats: iterations and residuals per member, the residual histories,
    scf_s."""
    eng = calc.engine
    t0 = time.perf_counter()
    f0 = (start_fock_batch(calc, theta_b) if dm0 is None
          else eng.fock(dm0, theta_b))
    f_star, _, n_iter, best_err, errh = diis_solve_batch(
        calc._step_and_err(theta_b), f0, calc.opts)
    bad = [e for e in best_err if not e <= calc.opts.tol]
    if bad:
        log(f"batched DIIS: {len(bad)} member(s) above tol (worst "
            f"{max(bad):.3e})", level=0)
    dm = eng.dm_from_fock(f_star, theta_b)
    calc._sync()
    if stats is not None:
        stats.update(iterations=n_iter, residual=best_err,
                     residual_history=errh,
                     scf_s=time.perf_counter() - t0)
    return dm


def energy_batch(calc, params_b, stats=None):
    """(nb,) total energies of the members of a batched params tree
    (datastruct.batch_params: positions and charges per member, the rest
    shared), differentiable in whatever leaves of params_b require grad,
    to any order: the port's jax.vmap(calc.energy_fn). theta is always
    rebuilt from params_b (never a cached theta: it would carry no graph).
    stats (a dict) gets batch, theta_s, iterations and residual per
    member, scf_s and the backward's GMRES records ('gmres')."""
    st = {} if stats is None else stats
    theta_b = build_theta_batch(calc, params_b, st)
    dm = implicit_fixed_point(
        calc.engine.step,
        lambda th, x0: solve_batch(calc, th, x0, st), theta_b, None,
        stats=st.setdefault("gmres", []))
    return calc.engine.energy(dm, theta_b)

