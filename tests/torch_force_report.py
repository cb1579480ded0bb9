"""Forces of the PyTorch/CUDA port and of the JAX package side by side, on
the CPU; a report, not a test (pytest does not collect it):

    JAX_PLATFORMS=cpu python tests/torch_force_report.py

Prints one JSON line per case:
- `benzene_hf_sto3g`: D6h benzene (C-C 1.39 A, C-H 1.09 A), RHF/STO-3G,
  tol 1e-11. Its orbitals and the levels of S come in degenerate pairs.
  For the port's energy_grad, the JAX package's energy_grad and jax.grad of
  its energy_fn: max |F|, the gap to the mirror images x -> -x and y -> -y
  (zero for exact forces), and for the port its GMRES records and central
  differences of its energy (h = 1e-4 Bohr) in two coordinates.
- `h2o_b3lyp_def2svp`: H2O B3LYP/def2-SVP on the level-2 grid, tol 1e-11
  (d shells, no degenerate level): max |dF| between the port's energy_grad
  and jax.grad of the JAX package's energy_fn.
- `benzene_df_metric_sto3g`: the density fit's own derivative, apart from
  the SCF's. At a fixed density (the port's converged DF HF density of
  benzene/STO-3G, autoaux), E_J(R) = 1/2 <J_fit(R; dm), dm> with the fit
  rebuilt from the positions: dE_J/dR of the JAX package (jax.grad through
  build_df_theta, whose v_inv takes safe_eigh's eigenvector rule on a
  metric with degenerate eigenvalues) and of the port (Cholesky), each
  with its mirror gap, and central differences of the port's E_J (h = 1e-4
  Bohr) in two coordinates.
Takes a few minutes on one core, most of it JAX compiles. Name cases on
the command line to run only those.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import dqc_tpu  # noqa: E402
import dqc_tpu_torch as dqt  # noqa: E402
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions  # noqa: E402

jax.config.update("jax_enable_x64", True)

BOHR = 0.52917721092
H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"


def benzene_desc():
    rcc, rch = 1.39 / BOHR, (1.39 + 1.09) / BOHR
    atoms = []
    for i in range(6):
        a = np.pi / 3 * i
        atoms.append(f"C {rcc * np.cos(a):.10f} {rcc * np.sin(a):.10f} 0.0")
        atoms.append(f"H {rch * np.cos(a):.10f} {rch * np.sin(a):.10f} 0.0")
    return "; ".join(atoms)


def mirror(F, axis):
    """Benzene forces mapped by axis -> -axis (C/H pair k at 60k degrees)."""
    G = np.zeros_like(F)
    for k in range(6):
        j = (3 - k) % 6 if axis == 0 else (-k) % 6
        G[2 * j:2 * j + 2] = F[2 * k:2 * k + 2]
        G[2 * j:2 * j + 2, axis] *= -1
    return G


def summary(F):
    return {"max_abs_F": float(np.abs(F).max()),
            "mirror_gap": max(float(np.abs(F - mirror(F, ax)).max())
                              for ax in (0, 1))}


def port_calc(desc, basis, grid, xc, **kw):
    mol = dqt.Mol(desc, basis=basis, grid=grid, device="cpu", **kw)
    opts = dqt.SCFOptions(tol=1e-11)
    qc = dqt.HF(mol, opts=opts) if xc is None else dqt.KS(mol, xc=xc,
                                                           opts=opts)
    return mol, qc


def jax_calc(desc, basis, grid, xc):
    mol = dqc_tpu.Mol(desc, basis=basis, grid=grid)
    opts = JOptions(tol=1e-11, mixed=False)
    return (dqc_tpu.HF(mol, opts=opts) if xc is None
            else dqc_tpu.KS(mol, xc=xc, opts=opts))


def jax_grad_forces(qc):
    p = qc._all_params()

    def e_of(pos):
        q = dict(p)
        q["basis"] = dict(p["basis"])
        q["basis"]["atompos"] = pos
        return qc.energy_fn(q)
    return -np.asarray(jax.jit(jax.grad(e_of))(p["basis"]["atompos"]))


def benzene():
    desc = benzene_desc()
    mol, qc = port_calc(desc, "sto-3g", 1, None)
    t0 = time.perf_counter()
    F = -qc.energy_grad()["basis"]["atompos"].numpy()
    rec = {"port": dict(summary(F), seconds=time.perf_counter() - t0,
                        gmres=qc.stats["gmres"])}
    fd = []
    for atom, axis in ((0, 0), (2, 0)):
        es = []
        for s in (1, -1):
            pos = mol.atompos.clone()
            pos[atom, axis] += s * 1e-4
            es.append(float(port_calc((mol.atomzs, pos), "sto-3g", 1,
                                      None)[1].run().energy()))
        d = -(es[0] - es[1]) / 2e-4
        fd.append({"atom": atom, "axis": axis, "fd": d,
                   "abs_diff": abs(d - float(F[atom, axis]))})
    rec["port"]["central_differences"] = fd
    jq = jax_calc(desc, "sto-3g", 1, None)
    jq.run()
    rec["jax_energy_grad"] = summary(
        -np.asarray(jq.energy_grad()["basis"]["atompos"]))
    rec["jax_grad_energy_fn"] = summary(jax_grad_forces(jq))
    return rec


def h2o():
    _, qc = port_calc(H2O, "def2-svp", 2, "b3lyp")
    F = -qc.energy_grad()["basis"]["atompos"].numpy()
    jq = jax_calc(H2O, "def2-svp", 2, "b3lyp")
    jq.run()
    Fj = jax_grad_forces(jq)
    return {"max_abs_F": float(np.abs(F).max()),
            "max_abs_dF_port_vs_jax": float(np.abs(F - Fj).max()),
            "gmres": qc.stats["gmres"]}


def benzene_df_metric():
    from dqc_tpu.ops.shellstruct import pack_basis as jpack
    from dqc_tpu.scf import df as jdf
    from dqc_tpu_torch.ops.shellstruct import pack_basis as tpack
    from dqc_tpu_torch.scf import df as tdf
    desc = benzene_desc()
    mol = dqt.Mol(desc, basis="sto-3g", device="cpu").densityfit()
    dm = dqt.HF(mol, opts=dqt.SCFOptions(tol=1e-11)).run()._dm.detach()
    meta_aux, params_aux = tpack(mol.dfinfo.auxbases)

    def e_port(pos):
        p = dict(mol.params, atompos=pos)
        pa = dict(params_aux, atompos=pos)
        df, _ = tdf.build_df_theta(mol.meta, p, meta_aux, pa)
        return 0.5 * (tdf.df_j(df, dm) * dm).sum()
    pos0 = mol.params["atompos"].detach()
    pos = pos0.clone().requires_grad_(True)
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(e_port(pos), pos)
    F = -g.numpy()
    rec = {"port": dict(summary(F), seconds=time.perf_counter() - t0)}
    fd = []
    with torch.no_grad():
        for atom, axis in ((0, 0), (2, 1)):
            es = []
            for s in (1, -1):
                q = pos0.clone()
                q[atom, axis] += s * 1e-4
                es.append(float(e_port(q)))
            d = -(es[0] - es[1]) / 2e-4
            fd.append({"atom": atom, "axis": axis, "fd": d,
                       "abs_diff": abs(d - float(F[atom, axis]))})
    rec["port"]["central_differences"] = fd
    jm = dqc_tpu.Mol(desc, basis="sto-3g").densityfit()
    jmeta_aux, jparams_aux = jpack(jm.dfinfo.auxbases)
    dm_np = dm.numpy()

    def e_jax(pos):
        p = dict(jm.params)
        p["atompos"] = pos
        pa = dict(jparams_aux)
        pa["atompos"] = pos
        df = jdf.build_df_theta(jm.meta, p, jmeta_aux, pa)
        return 0.5 * (jdf.df_j(df, dm_np) * dm_np).sum()
    t0 = time.perf_counter()
    Fj = -np.asarray(jax.jit(jax.grad(e_jax))(jm.params["atompos"]))
    rec["jax"] = dict(summary(Fj), seconds=time.perf_counter() - t0)
    rec["max_abs_dF_port_vs_jax"] = float(np.abs(F - Fj).max())
    return rec


CASES = {"benzene_hf_sto3g": benzene, "h2o_b3lyp_def2svp": h2o,
         "benzene_df_metric_sto3g": benzene_df_metric}

if __name__ == "__main__":
    torch.set_num_threads(1)
    for name in sys.argv[1:] or list(CASES):
        print(json.dumps({name: CASES[name]()}), flush=True)
