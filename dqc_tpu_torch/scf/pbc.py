"""theta of a periodic cell at the Gamma point (counterpart of
dqc_tpu/scf/pbc.py): overlap and kinetic as real-space lattice sums
(ops/pbc.py); the nuclear attraction, J and K in reciprocal space from the
analytic pair Fourier transforms (ops/pbcft.py), with the Ewald nuclei
energy and, for exact exchange, the probe-charge (Madelung) correction of
the dropped G = 0 term; or, after densityfit(method="gdf"), a Gaussian fit
in the periodic Coulomb metric. The XC grid is the cell-wrapped Becke grid
with lattice-summed AO tables, in the keys and layouts of the molecular
xc/integrate.setup_grid_theta, so K2/K3 and the XC code take it unchanged.

Everything downstream of params is torch, so the energy is differentiable
in the atom positions and the basis parameters. The JAX package's
jax.checkpoint of its chunk bodies is torch.utils.checkpoint here (Becke
chunks, pair-transform G blocks, AO-table point chunks); its lax.map
chunking is a Python loop over blocks sized by bytes.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..grid.becke import becke_weights
from ..ops.aoeval import eval_ao_pbc
from ..ops.pbc import estimate_rcut, gamma_int1e
from ..ops.pbcft import (aft_vnuc, coulomb_gweights, coulomb_gweights_sr,
                         eval_ao_ft, gcut_estimate, pbc_pair_ft,
                         pbc_pair_plan)
from ..system.lattice import ewald_energy
from ..utils.config import DTYPE
from ..xc.integrate import _deriv_of_family
from .df import pinv_sqrt
from .orth import orthogonalizer

# the JAX package's two precisions of a periodic cell: the core theta
# (lattice sums, G cutoff, pair plan) and the translations of the AO
# lattice sums
CORE_PRECISION = 1e-9
AO_PRECISION = 1e-8
# points per chunk of the lattice-summed AO tables (the translations inside
# a chunk are blocked by bytes, ops/aoeval.eval_ao_pbc)
AO_PT_CHUNK = 2048
# the G-space fitting metric keeps eigenvalues above this fraction of its
# largest (the JAX package's build_pbc_gdf)
GDF_METRIC_CUTOFF = 1e-10


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ao_chunk(meta, params, coords, ls_ao, deriv):
    tabs = eval_ao_pbc(meta, params, coords, ls_ao, deriv=deriv)
    out = [tabs["ao"]]
    if deriv >= 1:
        out.append(tabs["ao_grad"].permute(1, 0, 2))   # (3, chunk, nao)
    if deriv >= 2:
        out.append(tabs["ao_lapl"])
    return tuple(out)


def pbc_grid_points(params, pbcgrid):
    """(coords (ng, 3), dvol (ng,)) of the cell-wrapped grid on the device of
    params: the points move with the atoms, and the Becke weights run over
    the virtual atoms (grid/becke.py, in byte-sized chunks)."""
    atompos = params["atompos"]
    dev, dt = atompos.device, atompos.dtype

    def t(x, dtype=dt):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    coords = (atompos[t(pbcgrid.atom_idx, torch.int64)]
              + t(pbcgrid.ratom)[:, None] * t(pbcgrid.dirs)
              + t(pbcgrid.shift))
    vowner = t(pbcgrid.vowner, torch.int64)
    vpos = atompos[vowner] + t(pbcgrid.vshift)
    vradii = t(pbcgrid.atom_radii)[vowner]
    w_becke = becke_weights(coords, t(pbcgrid.vatom_idx, torch.int64), vpos,
                            vradii)
    return coords, t(pbcgrid.w0) * w_becke


def setup_pbc_grid_theta(meta, params, pbcgrid, ls_ao, family: int = 1,
                         stats=None):
    """PBCGridSpec -> grid tables on the device of params, in the keys and
    layouts of xc/integrate.setup_grid_theta: coords (ng, 3), dvol (ng,),
    ao (ng, nao), ao_grad (3, ng, nao), ao_lapl (ng, nao), family. The
    Becke weights run over the virtual atoms; the AO tables are lattice sums
    over ls_ao. `stats` gets becke_s and ao_tables_s."""
    dev = params["atompos"].device
    t0 = time.perf_counter()
    coords, dvol = pbc_grid_points(params, pbcgrid)
    _sync(dev)
    t1 = time.perf_counter()
    deriv = _deriv_of_family(family)
    ng = coords.shape[0]
    remat = torch.is_grad_enabled() and coords.requires_grad
    chunks = []
    for s in range(0, ng, AO_PT_CHUNK):
        args = (meta, params, coords[s:s + AO_PT_CHUNK], ls_ao, deriv)
        chunks.append(checkpoint(_ao_chunk, *args, use_reentrant=False)
                      if remat else _ao_chunk(*args))
    out = {"coords": coords, "dvol": dvol, "family": family,
           "ao": torch.cat([c[0] for c in chunks])}
    if deriv >= 1:
        out["ao_grad"] = torch.cat([c[1] for c in chunks], dim=1)
    if deriv >= 2:
        out["ao_lapl"] = torch.cat([c[2] for c in chunks])
    del chunks
    _sync(dev)
    if stats is not None:
        stats.update(becke_s=t1 - t0, ao_tables_s=time.perf_counter() - t1,
                     ngrid=ng, n_virtual_atoms=len(pbcgrid.vowner),
                     n_ao_translations=len(ls_ao))
    return out


def madelung_constant(lattice) -> float:
    """Probe-charge Madelung constant of the cell: minus twice the Ewald
    energy of one unit point charge in a neutralising background (PySCF's
    exxdiv="ewald"); 2.8372974794806 / L for a simple cubic cell of edge L.
    A frozen number of the calculation."""
    pos = torch.zeros((1, 3), dtype=DTYPE, device=lattice.a.device)
    return -2.0 * float(ewald_energy(torch.ones(1, dtype=DTYPE,
                                                device=pos.device), pos,
                                     lattice))


def build_pbc_core_theta(sol, params, atomzs, *, precision: float = 1e-9,
                         madelung=None, gdf_aux=None, lr_omegas=(),
                         stats=None):
    """params -> theta of the Gamma-point SCF: the real lattice-summed ovlp
    and hcore (kinetic plus the G-space nuclear attraction), X and keep,
    the Ewald nuclei energy, and either the pair transforms pbcft = {Fre,
    Fim, wcoul, madelung, wsr{i}} (the AFT route; wsr{i} the short-range
    weights of each omega of lr_omegas) or the periodic fit df (build_pbc_gdf
    on gdf_aux = (meta_aux, params_aux)) with one short-range fit df_sr{i}
    per omega. `stats` gets int1e_s (the lattice sums), n_translations,
    pair_ft_s, n_gvectors, n_pair_terms, vnuc_s and gdf_s."""
    meta, lat = sol.meta, sol.lattice
    dev = params["atompos"].device
    t0 = time.perf_counter()
    ls = lat.get_lattice_ls(estimate_rcut(meta, sol.params, precision))
    ovlp = gamma_int1e("overlap", meta, params, ls)
    kin = gamma_int1e("kinetic", meta, params, ls)
    _sync(dev)
    t1 = time.perf_counter()
    Gv, _ = lat.get_gvgrids(gcut_estimate(meta, sol.params, precision))
    plan = pbc_pair_plan(meta, sol.params, lat, precision)
    Fre, Fim = pbc_pair_ft(meta, params, plan, Gv)
    _sync(dev)
    t2 = time.perf_counter()
    vol = lat.volume()
    w = coulomb_gweights(Gv, vol)
    vne = aft_vnuc(Fre, Fim, w, atomzs, params["atompos"], Gv)
    X, keep = orthogonalizer(ovlp, 1e-9)
    theta = {"hcore": kin + vne, "ovlp": ovlp, "X": X, "keep": keep,
             "enuc": ewald_energy(atomzs, params["atompos"], lat)}
    _sync(dev)
    t3 = time.perf_counter()
    times = {"int1e_s": t1 - t0, "n_translations": len(ls),
             "pair_ft_s": t2 - t1, "n_gvectors": len(Gv),
             "n_pair_terms": sum(len(q) for _, q, _ in plan),
             "vnuc_s": t3 - t2}
    if gdf_aux is None:
        theta["pbcft"] = {"Fre": Fre, "Fim": Fim, "wcoul": w,
                          "madelung": madelung}
        for i, om in enumerate(lr_omegas):
            theta["pbcft"][f"wsr{i}"] = coulomb_gweights_sr(Gv, vol, om)
    else:
        meta_aux, params_aux = gdf_aux
        chi = eval_ao_ft(meta_aux, params_aux, Gv)
        theta["df"] = build_pbc_gdf(Fre, Fim, w, chi, madelung=madelung,
                                    ovlp=ovlp)
        for i, om in enumerate(lr_omegas):
            theta[f"df_sr{i}"] = build_pbc_gdf(
                Fre, Fim, coulomb_gweights_sr(Gv, vol, om), chi)
        del Fre, Fim
        _sync(dev)
        times.update(gdf_s=time.perf_counter() - t3, naux=meta_aux.nao)
    if stats is not None:
        stats.update(times)
    return theta


def build_pbc_gdf(Fre, Fim, w, chi, *, madelung=None, ovlp=None):
    """The periodic fit in the G-space Coulomb metric, in the factored form
    of scf/df.py ({'B': (nao, naux, nao)}, sum_Q B_Q x B_Q = j3c v^+ j3c):

        j3c_{ij,P} = sum_G w_G Re[F_ij(G) chi_P(G)^*],
        v_PQ       = sum_G w_G Re[chi_P(G) chi_Q(G)^*],

    chi = (re, im) (ng, naux) the aux functions' Fourier transforms
    (ops/pbcft.eval_ao_ft). v^+ is the JAX package's pseudo-inverse on the
    eigenvalues above GDF_METRIC_CUTOFF of the largest (the G = 0 drop
    leaves v near-singular), here as B = v^(+1/2) j3c (scf/df.pinv_sqrt).
    With madelung, the dict also carries it and ovlp: df_k adds the
    exchange's G = 0 correction M S dm S."""
    cre, cim = chi
    ng, nao = Fre.shape[0], Fre.shape[-1]
    wre, wim = w[:, None] * cre, w[:, None] * cim
    j3c = (Fre.reshape(ng, nao * nao).T @ wre
           + Fim.reshape(ng, nao * nao).T @ wim)          # (nao^2, naux)
    v = cre.T @ wre + cim.T @ wim
    ph, _ = pinv_sqrt(0.5 * (v + v.T), GDF_METRIC_CUTOFF)
    b = (j3c @ ph).reshape(nao, nao, -1).permute(0, 2, 1).contiguous()
    out = {"B": b}
    if madelung is not None:
        out["madelung"] = madelung
        out["ovlp"] = ovlp
    return out
