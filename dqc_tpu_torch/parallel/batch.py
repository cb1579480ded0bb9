"""A batch of geometries of one system through one SCF: the port's batch
axis.

Counterpart of the `dp` axis of dqc_tpu/parallel/mesh.py (the batch of
molecules that neural-XC training maps over), which the JAX package runs
as jax.vmap(calc.energy_fn): vmap batches each pallas_call along a new grid
axis and each while_loop per member. PyTorch has no vmap of a Python SCF
loop with a host sync per iteration, so the batch is written out here:

  - theta: each member's integrals, eri_k (or its fit, blocks, factors,
    pair transforms) and its moving grid, built by the calc's own
    _build_theta from the member's params and stacked on a leading axis.
    Everything host-side that sizes theta is the calc's own, fixed by its
    system when the calc was made and never recomputed from a member's
    positions (static at trace time under jax.vmap in the JAX package):
    the grid spec, the Schwarz-screened jk_meta of the blocked and streamed
    routes, the pair plans, translations and G vectors of a periodic cell,
    its cell-wrapped grid with its virtual atoms, and ls_ao. So the
    members' parts have equal shapes (a part that does not raises, naming
    it), and the member at the system's own geometry gets the unbatched
    calc's theta bit for bit;
  - the engines' products carry the axis (scf/engine.py, scf/kpbc.py,
    xc/integrate.py), and K1-K3 take it in ONE launch each per Fock build
    (on the k-point engine K2 and K3 once per k-point and spin, each over
    all members' tables at that k). Contractions that are not kernels (the
    blocked and streamed J/K, a periodic cell's J and K, the k-point
    engine's J, exchange and eigensolves) run member by member on their
    member's theta;
  - the solver is that of the calc's route and method, for the batch:
    scf/fixed_point.diis_solve_batch (a DIIS history, best iterate and
    patience per member, one host sync per iteration for the whole batch,
    a stopped member frozen as the vmapped while_loop freezes it); the
    streamed route's RI phase and dual-level polish with a stop per member
    (qccalc.SCF_QCCalc._stream_solve_batch, whose batch of one is the
    unbatched calc's); or the variational solver's one BFGS over the
    members' stacked parameters (qccalc.SCF_QCCalc._variational_solver,
    which takes a stacked theta as it takes one system's);
  - the derivative is the same implicit_fixed_point: the batched step map
    is block-diagonal in the members, and its adjoint is solved by GMRES
    over the stacked vector, one batched matvec (one launch of each
    kernel's backward) per Krylov step. A block-diagonal system solved as
    one is exact, and the members share their spectrum's shape (one
    system at nearby geometries), so the Krylov space of the stack is
    not much larger than a member's; derivatives to any order stay those
    of _LinSolve.

Every route of the unbatched calc takes a batch: dense, density-fitted,
blocked, streamed, a periodic cell at the Gamma point (pair transforms or
the periodic fit) and with k-points, and the variational solver (a k-point
cell refuses it, as its unbatched calc does).

On one card the mesh's other axes have no counterpart (PERF.md §6): `grid`
and `tp` shard the grid points and the fit's aux axis over TPU chips, and
jk_from_blocks' mesh sharding spreads the quartet blocks over them.
"""
from __future__ import annotations

import time

import torch

from ..scf.fixed_point import diis_solve_batch, implicit_fixed_point
from ..scf.jk import jk_blocks_nbytes
from ..utils.datastruct import batch_size, member_params
from ..utils.logger import log


def _stack_into(out, th, m, nb, path=()):
    """Member m's theta th into the stacked dict out (allocated at m = 0):
    tensors into their slot of a (nb, ...) tensor, anything else kept from
    member 0. A part whose shape differs from member 0's raises, naming
    it; so does a stack the device cannot hold."""
    for k, v in th.items():
        where = path + (k,)
        if isinstance(v, dict):
            _stack_into(out.setdefault(k, {}), v, m, nb, where)
        elif isinstance(v, torch.Tensor):
            if m == 0:
                try:
                    out[k] = v.new_empty((nb,) + tuple(v.shape))
                except torch.OutOfMemoryError as ex:
                    raise MemoryError(
                        f"the batch's theta part {'/'.join(where)} needs "
                        f"{nb} x {v.numel() * v.element_size()} bytes, which "
                        f"{v.device} could not allocate: {ex}") from ex
                tag = getattr(v, "jk_tag", None)
                if tag is not None:
                    out[k].jk_tag = tag
            elif tuple(v.shape) != tuple(out[k].shape[1:]):
                raise ValueError(
                    f"theta part {'/'.join(where)} of member {m} has shape "
                    f"{tuple(v.shape)}, member 0's {tuple(out[k].shape[1:])}"
                    ": a batch needs the same host-side plans for every "
                    "member")
            out[k][m] = v
        elif m == 0:
            out[k] = v


def build_theta_batch(calc, params_b, stats=None):
    """theta of every member of a batched params tree (datastruct.
    batch_params), stacked (nb, ...); xc_params stay the shared tree.
    Each member's theta is built, copied into the stack and dropped before
    the next one starts. Differentiable in the params as the calc's own
    build is (the stack's copies carry the graph). stats: batch, theta_s,
    and on the blocked route jk_blocks_bytes_batch, the stack's bytes of
    quartet blocks (nb x scf/jk.jk_blocks_nbytes)."""
    nb = batch_size(params_b)
    t0 = time.perf_counter()
    info = getattr(calc.engine, "jk_info", None)
    if calc.jk_mode == "blocked" and info is not None:
        nbytes = nb * jk_blocks_nbytes(info[1])
        if stats is not None:
            stats["jk_blocks_bytes_batch"] = nbytes
        log(f"batch of {nb}: {nbytes} bytes of quartet blocks")
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


def solve_batch(calc, theta_b, dm0=None, stats=None):
    """The converged density matrices (nb, ...) of a stacked theta by the
    calc's solver for a batch: batched DIIS from F(dm0), or from the start
    Fock without one (SCF_QCCalc._start_fock of the stack); the streamed
    route's two-level SCF (SCF_QCCalc._stream_solve_batch); or the
    variational solver over all members (method "variational"). stats:
    iterations and residuals per member, the residual histories, the
    route's records, scf_s."""
    eng = calc.engine
    t0 = time.perf_counter()
    st = {} if stats is None else stats
    if calc.opts.method == "variational":
        dm = calc._variational_solver(theta_b, dm0, stats=st)
    elif "jk_facs" in theta_b:
        dm = calc._stream_solve_batch(theta_b, dm0, st)
    else:
        f0 = (calc._start_fock(theta_b, st) if dm0 is None
              else eng.fock(dm0, theta_b))
        f_star, _, n_iter, best_err, errh = diis_solve_batch(
            calc._step_and_err(theta_b), f0, calc.opts)
        bad = [e for e in best_err if not e <= calc.opts.tol]
        if bad:
            log(f"batched DIIS: {len(bad)} member(s) above tol (worst "
                f"{max(bad):.3e})", level=0)
        dm = eng.dm_from_fock(f_star, theta_b)
        st.update(iterations=n_iter, residual=best_err,
                  residual_history=errh)
    calc._sync()
    st["scf_s"] = time.perf_counter() - t0
    return dm


def energy_batch(calc, params_b, stats=None):
    """(nb,) total energies of the members of a batched params tree
    (datastruct.batch_params: positions and charges per member, the rest
    shared), differentiable in whatever leaves of params_b require grad,
    to any order: the port's jax.vmap(calc.energy_fn), on every route the
    calc runs. theta is always rebuilt from params_b (never a cached
    theta: it would carry no graph). stats (a dict) gets batch, theta_s,
    iterations and residual per member, the route's records, scf_s and the
    backward's GMRES records ('gmres')."""
    st = {} if stats is None else stats
    theta_b = build_theta_batch(calc, params_b, st)
    dm = implicit_fixed_point(
        calc.engine.step,
        lambda th, x0: solve_batch(calc, th, x0, st), theta_b, None,
        stats=st.setdefault("gmres", []))
    return calc.engine.energy(dm, theta_b)
