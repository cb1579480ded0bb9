"""JAX-CPU anchors of chip_smoke.py's benzene phases; a report, not a test
(pytest does not collect it):

    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py camb3lyp scan nnxc
    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py df_b3lyp df_camb3lyp
    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py --factored \
        df_b3lyp df_camb3lyp df_vitc
    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py properties
    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py pbc_h8_hf \
        pbc_h8_pbe pbc_h8_pbe0 pbc_h8_camb3lyp
    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py --factored \
        pbc_h8_gdf_pbe pbc_h8_gdf_camb3lyp
    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py pbc_h2_grad
    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py --factored \
        batch_routes
    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py pbc_k3_hf \
        pbc_k3_pbe pbc_k3_pbe0 pbc_k3_camb3lyp pbc_k3_scan pbc_k3_uks_pbe
    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py --factored \
        pbc_k3_gdf_pbe

For each functional named on the command line, one JSON line: the energy
of dqc_tpu.KS(benzene/def2-SVP, grid=2, xc, SCFOptions(mixed=False)) (the
geometry of chip_smoke.benzene_desc), the seconds it took, the achieved
DIIS residual and the tolerance. Takes minutes per functional on one core.
"nnxc" is the family-2 neural functional of chip_smoke.py's nn_xc phase
(nn_params_np, nn_edens: the same seed, parameters and formula), as a
CustomXC of the JAX package. A name with the prefix "df_" runs the
functional after it on the density-fitted route, mol.densityfit() with
the generated autoaux basis (chip_smoke.py's df_b3lyp and df_cam_b3lyp
phases); the line then also has naux. "df_vitc" is the workload of
benchmarks/vitamin_c.py (vitamin C/cc-pVDZ, grid 2, densityfit(),
lda_x+lda_c_pw).

"properties" runs the property API of dqc_tpu.api.properties (one JSON
line per system, each property as a list): H2O HF/3-21G at the CCCBDB
geometry of tests/test_properties.py (chip_smoke.py's props_h2o_hf) and
H2O HF/STO-3G at the same geometry (tests/test_torch_properties.py), all
of hessian_pos, vibration, ir_spectrum, raman_spectrum, edipole,
equadrupole, eoctupole, polarizability and lowest_eival_orb_hessian;
H2 HF/3-21G's optimal_geometry from a 1.3 Bohr start; B3LYP H2/3-21G grid
1's polarizability; and the variational energies (matexp, qr, ov) of HF
H2/3-21G and of the H atom (spin 1, ov) beside their DIIS energies
(tests/test_torch_variational.py). SCFOptions(mixed=False, tol=1e-11).
The names props_h2o_321g, props_h2o_sto3g and props_small run one part
each. Takes tens of minutes on one core, most of it the Raman
spectrum's compile.

A name with the prefix "pbc_h8_" runs chip_smoke.py's periodic phase of
that name: the 2x2x2 supercell of the simple-cubic H lattice at a = 3 Bohr
(H8 in a 6-Bohr cube, h8_desc), 3-21G, grid "sg2", restricted, at the
Gamma point, SCFOptions(mixed=False). "pbc_h8_hf" prints two lines,
exxdiv "ewald" and None; "pbc_h8_<xc>" runs KS with that functional on
the pair-Fourier-transform route, "pbc_h8_gdf_<xc>" after
sol.densityfit(method="gdf") (autoaux). Each takes minutes on one core
(the JAX package's Becke weights over the 465 virtual atoms of the
wrapped grid) and about 12 GB.

A name with the prefix "pbc_k3_" runs chip_smoke.py's k-point phase of
that name: the same H8 cell on the three-point mesh k = (n pi/9, 0, 0)
Bohr^-1, n = 0, 1, 2 (K3_MESH), SCFOptions(mixed=False); "pbc_k3_hf"
prints two lines (exxdiv "ewald" and None; "pbc_k3_hf_ewald" and
"pbc_k3_hf_none" one each), "pbc_k3_uks_<xc>" runs KS with
restricted=False, "pbc_k3_gdf_<xc>" after sol.densityfit(method="gdf")
(with --factored the JAX package's k-point fit, build_kpbc_gdf, is
contracted in factored form, as its periodic fit is). Each takes minutes
on one core. For these the JAX package's pbc_pair_ft_k
is evaluated by blocked_pbc_pair_ft_k: the same Hermite terms, phases
and scatter-adds, but with the phases applied inside each G block. The
package's own function keeps the (ng, pair x translation) transforms of
every G before the k loop, 72 GB for H8 (RESOURCE_EXHAUSTED on a 62 GB
host).

"pbc_h2_grad" prints jax.grad of the JAX package's periodic energy_fn in
the atom positions, jitted in the positions alone, for HF and for lda_x on
tests/test_torch_pbc.py's H2 force cell (H2 in a 5-Bohr cube, the two-s
SOFT_H basis, grid 0; its grid statics frozen as in the port; SCF tol
1e-12), one JSON line each; the test holds the port's energy_grad against
these values. About a minute on one core.

"batch_routes" prints jax.vmap of the JAX package's energy_fn over the
two members of each case of tests/test_torch_batch_routes.py's JAX_CASES
(its member_positions), one JSON line each: the blocked route of H2O
(DENSE_ERI_BYTES_LIMIT set to 0 for the run), the Gamma-point H2 cell on
the pair transforms and on the periodic fit (run with --factored), and
the k-point He cell; "batch_<case>" runs one case. 17-57 s each on one
core.

--factored: the JAX package's fit is contracted in factored form. Its
build_df_theta returns j3c and v_inv = j2c^+ (eigh pseudo-inverse above
1e-12 of the largest eigenvalue), and df_j/df_k contract j3c with the
explicit v_inv, which loses about eps * cond(j2c) to cancellation (up to
1e-6 relative in K with an erf-attenuated metric). With the flag,
dqc_tpu.scf.df.build_df_theta is replaced for the run by the same pseudo-
inverse in factored form: j3c -> j3c V diag(w^-1/2) on the kept spectrum
and v_inv -> I, so that df_j and df_k, unchanged, compute the same function
without the cancellation. Nothing else of the JAX package changes. The periodic
fit (dqc_tpu.scf.pbc.build_pbc_gdf, eigh pseudo-inverse above 1e-10 of the
largest eigenvalue of the G-space metric) is factored the same way.

The JAX package refuses range separation on its blocked J/K route, which it
takes at this size (its dense limit is 600 MiB); for a functional with
long-range exchange the script raises that limit for the run
(dqc_tpu.scf.qccalc.DENSE_ERI_BYTES_LIMIT), so the anchor comes from the
dense route, the port's route.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import dqc_tpu  # noqa: E402
from dqc_tpu.scf import qccalc as jqccalc  # noqa: E402
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions  # noqa: E402
from dqc_tpu.xc import get_xc  # noqa: E402
from dqc_tpu.xc.custom import CustomXC  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_enable_x64", True)

BOHR = 0.529177210903   # chip_smoke.ANGSTROM_TO_BOHR = 1 / BOHR


def benzene_desc():
    rcc, rch = 1.39 / BOHR, (1.39 + 1.09) / BOHR
    atoms = []
    for i in range(6):
        a = np.pi / 3 * i
        atoms.append(f"C {rcc*np.cos(a):.10f} {rcc*np.sin(a):.10f} 0.0")
        atoms.append(f"H {rch*np.cos(a):.10f} {rch*np.sin(a):.10f} 0.0")
    return "; ".join(atoms)


NN_SEED = 8


def nn_params_np():
    """The seeded parameters of chip_smoke.nn_params_np."""
    rng = np.random.default_rng(NN_SEED)
    return {"w1": 0.5 * rng.standard_normal(8),
            "ws": 0.5 * rng.standard_normal(8),
            "b1": 0.1 * rng.standard_normal(8),
            "w2": 0.5 * rng.standard_normal((8, 1)),
            "b2": 0.1 * rng.standard_normal(1)}


def nn_edens(p, d):
    """examples/04_neural_xc.py's functional with s = |grad rho|/rho^(4/3)
    as a second input (chip_smoke.nn_edens in torch)."""
    rho, sigma = d["rho"], d["sigma"]
    n43 = rho ** (4.0 / 3.0)
    x = rho ** (1.0 / 3.0)
    s = jnp.sqrt(jnp.maximum(sigma, 1e-40)) / n43
    h = jnp.tanh(x[..., None] * p["w1"] + s[..., None] * p["ws"] + p["b1"])
    f = 1.0 + 0.2 * jnp.tanh(h @ p["w2"] + p["b2"])[..., 0]
    c = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)
    return -c * n43 * f


def resolve(name):
    if name == "nnxc":
        p = {k: jnp.asarray(v) for k, v in nn_params_np().items()}
        return CustomXC(nn_edens, p, family=2, key="nnxc")
    return name


def factored_build_df_theta(meta, params, meta_aux, params_aux, omega=None):
    """dqc_tpu.scf.df.build_df_theta's pseudo-inverse in factored form
    (module docstring)."""
    from dqc_tpu.ops.eri import coul2c, coul3c
    j2c = coul2c(meta_aux, params_aux, omega=omega)
    j3c = coul3c(meta, params, meta_aux, params_aux, omega=omega)
    w, v = jnp.linalg.eigh(j2c)
    keep = w > 1e-12 * w[-1]
    f = jnp.where(keep, 1.0 / jnp.sqrt(jnp.where(keep, w, 1.0)), 0.0)
    return {"j3c": jnp.einsum("ijp,pq->ijq", j3c, v * f[None, :]),
            "v_inv": jnp.eye(w.shape[0], dtype=w.dtype)}


def factored_build_pbc_gdf(Fre, Fim, w, meta_aux, params_aux, Gv, *,
                           madelung=None, ovlp=None):
    """dqc_tpu.scf.pbc.build_pbc_gdf's pseudo-inverse in factored form
    (module docstring): the same metric and 3-centre tensors, j3c -> j3c V
    diag(w^-1/2) on the kept spectrum and v_inv -> I."""
    from dqc_tpu.ops.pbcft import eval_ao_ft
    nao, ng = Fre.shape[-1], Fre.shape[0]
    cre, cim = eval_ao_ft(meta_aux, params_aux, jnp.asarray(Gv))
    fre, fim = Fre.reshape(ng, nao * nao), Fim.reshape(ng, nao * nao)
    j3c = (jnp.einsum("gx,g,gp->xp", fre, w, cre)
           + jnp.einsum("gx,g,gp->xp", fim, w, cim)).reshape(nao, nao, -1)
    v = (jnp.einsum("gp,g,gq->pq", cre, w, cre)
         + jnp.einsum("gp,g,gq->pq", cim, w, cim))
    ew, ev = jnp.linalg.eigh(0.5 * (v + v.T))
    keep = ew > 1e-10 * jnp.max(ew)
    f = jnp.where(keep, 1.0 / jnp.sqrt(jnp.where(keep, ew, 1.0)), 0.0)
    out = {"j3c": jnp.einsum("ijp,pq->ijq", j3c, ev * f[None, :]),
           "v_inv": jnp.eye(ew.shape[0], dtype=ew.dtype)}
    if madelung is not None:
        out["madelung"] = jnp.asarray(madelung)
        out["ovlp"] = ovlp
    return out


def h8_desc(a=3.0, n=2):
    """The n x n x n supercell of the simple-cubic H lattice of edge a
    (chip_smoke.h_supercell)."""
    return "; ".join(f"H {i * a} {j * a} {k * a}" for i in range(n)
                     for j in range(n) for k in range(n))


def pbc_h8(name, factored):
    """chip_smoke.py's pbc_h8_* phases (module docstring)."""
    from dqc_tpu.system.sol import Sol
    rest = name[len("pbc_h8_"):]
    gdf = rest.startswith("gdf_")
    xc = rest[4:] if gdf else rest
    runs = ([("hf", "ewald"), ("hf", None)] if xc == "hf"
            else [(xc, "ewald")])
    for xc, exxdiv in runs:
        t0 = time.perf_counter()
        sol = Sol(h8_desc(), np.eye(3) * 6.0, basis="3-21g", grid="sg2")
        if gdf:
            sol = sol.densityfit(method="gdf")
        opts = JOptions(mixed=False, exxdiv=exxdiv)
        qc = (dqc_tpu.HF(sol, opts=opts) if xc == "hf"
              else dqc_tpu.KS(sol, xc=xc, opts=opts)).run()
        print(json.dumps({
            "system": "H8", "alattice_bohr": 6.0, "basis": "3-21g",
            "grid": "sg2", "xc": xc, "exxdiv": exxdiv,
            "route": "gdf" if gdf else "aft", "factored": factored,
            "energy_ha": float(qc.energy()), "nao": sol.meta.nao,
            "seconds": time.perf_counter() - t0,
            "residual": getattr(qc, "_achieved_err", None), "tol": opts.tol,
            "backend": jax.default_backend()}), flush=True)


K3_MESH = np.array([[n * np.pi / 9.0, 0.0, 0.0] for n in range(3)])


def factored_build_kpbc_gdf(Qre, Qim, w, meta_aux, params_aux, Gv):
    """dqc_tpu.scf.kpbc.build_kpbc_gdf's pseudo-inverse in factored form:
    T -> T V diag(w^-1/2) on the kept spectrum of the metric and v_inv ->
    I (module docstring)."""
    from dqc_tpu.ops.pbcft import eval_ao_ft
    cre, cim = eval_ao_ft(meta_aux, params_aux, jnp.asarray(Gv))
    Tre = (jnp.einsum("kgij,g,gp->kijp", Qre, w, cre)
           + jnp.einsum("kgij,g,gp->kijp", Qim, w, cim))
    Tim = (jnp.einsum("kgij,g,gp->kijp", Qim, w, cre)
           - jnp.einsum("kgij,g,gp->kijp", Qre, w, cim))
    v = (jnp.einsum("gp,g,gq->pq", cre, w, cre)
         + jnp.einsum("gp,g,gq->pq", cim, w, cim))
    ew, ev = jnp.linalg.eigh(0.5 * (v + v.T))
    keep = ew > 1e-10 * jnp.max(ew)
    f = jnp.where(keep, 1.0 / jnp.sqrt(jnp.where(keep, ew, 1.0)), 0.0)
    h = ev * f[None, :]
    return {"Tre": jnp.einsum("kijp,pq->kijq", Tre, h),
            "Tim": jnp.einsum("kijp,pq->kijq", Tim, h),
            "v_inv": jnp.eye(ew.shape[0], dtype=ew.dtype)}


def blocked_pbc_pair_ft_k(meta, params, plan, Gv, kpts, g_block=512):
    """dqc_tpu.ops.pbcft.pbc_pair_ft_k with the k loop and the scatter to
    the AO pairs inside each G block (module docstring): the same terms of
    the same function, evaluated block by block."""
    from dqc_tpu.ops.chunks import map_blocks
    from dqc_tpu.ops.eri import hermite_factor_pair
    from dqc_tpu.ops.pbcft import gpow_table
    from dqc_tpu.ops.shellstruct import gather_pair_inputs, pair_ao_indices
    nao, ng = meta.nao, Gv.shape[0]
    kpts = np.asarray(kpts)
    nk = len(kpts)
    classes = []
    for pc, qidx, shifts in plan:
        if len(qidx) == 0:
            continue
        inp = gather_pair_inputs(meta, params, pc)
        q = jnp.asarray(qidx)
        ext = {"A": inp["A"][q], "B": inp["B"][q] + jnp.asarray(shifts),
               "aa": inp["aa"][q], "ab": inp["ab"][q],
               "ca": inp["ca"][q], "cb": inp["cb"][q],
               "la": inp["la"], "lb": inp["lb"]}
        kdot = kpts @ shifts.T
        classes.append((hermite_factor_pair(ext), pc.npair, jnp.asarray(qidx),
                        jnp.asarray(pair_ao_indices(meta, pc).ravel()),
                        jnp.asarray(np.cos(kdot)), jnp.asarray(np.sin(kdot))))

    def body(Gc):
        gc = Gc.shape[0]
        out_re = jnp.zeros((nk, gc, nao * nao))
        out_im = jnp.zeros((nk, gc, nao * nao))
        for bra, npair, seg, idx, ck, sk in classes:
            Wre, Wim = gpow_table(bra.L, Gc)
            Tre = jnp.einsum("pksh,gh->pksg", bra.H, Wre)
            Tim = jnp.einsum("pksh,gh->pksg", bra.H, Wim)
            g2 = jnp.sum(Gc * Gc, axis=-1)
            damp = ((jnp.pi / bra.p[..., None]) ** 1.5
                    * jnp.exp(-g2[None, None, :] / (4.0 * bra.p[..., None])))
            ph = jnp.einsum("pkd,gd->pkg", bra.P, Gc)
            c, s = damp * jnp.cos(ph), damp * jnp.sin(ph)
            fre = (jnp.einsum("pkg,pksg->gps", c, Tre)
                   + jnp.einsum("pkg,pksg->gps", s, Tim))
            fim = (jnp.einsum("pkg,pksg->gps", c, Tim)
                   - jnp.einsum("pkg,pksg->gps", s, Tre))
            nsph = fre.shape[-1]
            for k in range(nk):
                qre = jnp.zeros((gc, npair, nsph)).at[:, seg, :].add(
                    ck[k][None, :, None] * fre - sk[k][None, :, None] * fim)
                qim = jnp.zeros((gc, npair, nsph)).at[:, seg, :].add(
                    ck[k][None, :, None] * fim + sk[k][None, :, None] * fre)
                out_re = out_re.at[k, :, idx].add(qre.reshape(gc, -1).T)
                out_im = out_im.at[k, :, idx].add(qim.reshape(gc, -1).T)
        return out_re.swapaxes(0, 1), out_im.swapaxes(0, 1)

    re, im = map_blocks(body, jnp.asarray(Gv), ng, g_block)
    return (re.swapaxes(0, 1).reshape(nk, ng, nao, nao),
            im.swapaxes(0, 1).reshape(nk, ng, nao, nao))


def _blocked_k_transforms():
    """Puts blocked_pbc_pair_ft_k in the place of the JAX package's
    pbc_pair_ft_k for the run (both modules that call it)."""
    from dqc_tpu.ops import pbcft as jpbcft
    from dqc_tpu.scf import kpbc as jkpbc
    jpbcft.pbc_pair_ft_k = blocked_pbc_pair_ft_k
    jkpbc.pbc_pair_ft_k = blocked_pbc_pair_ft_k


def pbc_k3(name, factored):
    """chip_smoke.py's pbc_k_h8_3mesh_* phases (module docstring)."""
    from dqc_tpu.system.sol import Sol
    rest = name[len("pbc_k3_"):]
    gdf = rest.startswith("gdf_")
    uks = rest.startswith("uks_")
    xc = rest[4:] if (gdf or uks) else rest
    runs = {"hf": [("hf", "ewald"), ("hf", None)],
            "hf_ewald": [("hf", "ewald")],
            "hf_none": [("hf", None)]}.get(xc, [(xc, "ewald")])
    for xc, exxdiv in runs:
        t0 = time.perf_counter()
        sol = Sol(h8_desc(), np.eye(3) * 6.0, basis="3-21g", grid="sg2",
                  kpts=K3_MESH)
        if gdf:
            sol = sol.densityfit(method="gdf")
        opts = JOptions(mixed=False, exxdiv=exxdiv)
        kw = {"restricted": False} if uks else {}
        qc = (dqc_tpu.HF(sol, opts=opts, **kw) if xc == "hf"
              else dqc_tpu.KS(sol, xc=xc, opts=opts, **kw)).run()
        print(json.dumps({
            "system": "H8", "alattice_bohr": 6.0, "basis": "3-21g",
            "grid": "sg2", "kpts": K3_MESH.tolist(), "xc": xc,
            "exxdiv": exxdiv, "route": "gdf" if gdf else "aft",
            "restricted": not uks, "factored": factored,
            "energy_ha": float(qc.energy()), "nao": sol.meta.nao,
            "seconds": time.perf_counter() - t0,
            "residual": getattr(qc, "_achieved_err", None), "tol": opts.tol,
            "backend": jax.default_backend()}), flush=True)


def pbc_h2_grad():
    """jax.grad of the periodic energy_fn of the H2 force cell (module
    docstring)."""
    from dqc_tpu.system.sol import Sol
    from test_torch_pbc import H2_FORCE_CELL
    for xc in (None, "lda_x"):
        t0 = time.perf_counter()
        sol = Sol(**H2_FORCE_CELL)
        opts = JOptions(mixed=False, tol=1e-12)
        qc = (dqc_tpu.HF(sol, opts=opts) if xc is None
              else dqc_tpu.KS(sol, xc=xc, opts=opts))
        p = qc._all_params(with_fields=False)

        def e_of_pos(pos):
            return qc.energy_fn(dict(p, basis=dict(p["basis"], atompos=pos)))
        g = jax.jit(jax.grad(e_of_pos))(p["basis"]["atompos"])
        print(json.dumps({
            "system": "H2 force cell", "xc": xc, "grad": _lists(g),
            "seconds": time.perf_counter() - t0,
            "backend": jax.default_backend()}), flush=True)


def batch_route(case):
    """jax.vmap of energy_fn over one case of test_torch_batch_routes.py
    (module docstring)."""
    from dqc_tpu.system.sol import Sol
    import test_torch_batch_routes as tb
    system, xc, route = tb.JAX_CASES[case]
    t0 = time.perf_counter()
    opts = JOptions(mixed=False)
    dense_limit = jqccalc.DENSE_ERI_BYTES_LIMIT
    if system == "water":
        jqccalc.DENSE_ERI_BYTES_LIMIT = 0
        mol = dqc_tpu.Mol(tb.WATER, basis="sto-3g", grid=0)
    else:
        cell = dict(tb.CELLS[system])
        desc, a = cell.pop("soldesc"), cell.pop("alattice")
        mol = Sol(desc, a, **cell)
        if route == "gdf":
            mol = mol.densityfit(method="gdf")
    try:
        qc = (dqc_tpu.HF(mol, opts=opts) if xc is None
              else dqc_tpu.KS(mol, xc=xc, opts=opts))
        p0 = qc._all_params(with_fields=False)
        pos = tb.member_positions(np.asarray(p0["basis"]["atompos"]))

        def one(q):
            return qc.energy_fn(dict(p0, basis=dict(p0["basis"],
                                                    atompos=q)))
        es = jax.jit(jax.vmap(one))(jnp.asarray(pos))
        es = [float(e) for e in np.asarray(es)]
    finally:
        jqccalc.DENSE_ERI_BYTES_LIMIT = dense_limit
    print(json.dumps({"case": case, "system": system, "xc": xc,
                      "route": route, "energies_ha": es,
                      "seconds": time.perf_counter() - t0,
                      "backend": jax.default_backend()}), flush=True)


VITAMIN_C = """O 0.1761 -2.0912 1.2179; O -2.5390 0.1686 -2.6197;
O 1.5859 4.5166 0.5374; O -7.3565 -0.3855 -0.6285;
O 5.7108 1.0762 -1.1444; O 3.7634 -4.0742 -0.2600;
C -0.6419 0.4947 1.4840; C -3.0347 0.8664 -0.0624;
C 1.5518 1.9398 0.5456; C -5.1899 -0.7714 0.9190;
C 3.4161 0.4295 -0.1982; C 2.5579 -2.1696 0.2094;
H -0.9740 0.8710 3.4930; H -3.6211 2.8520 -0.0816;
H -4.7222 -2.7845 0.8222; H -5.6716 -0.2763 2.8684;
H -2.0785 -1.6104 -2.6430; H 0.0074 5.0941 1.2812;
H -8.6971 -1.4445 0.0486; H 6.6186 -0.4860 -1.4846"""


H2O_CCCBDB = "O 0.0 0.0 0.2156; H 0.0 1.4749 -0.8625; H 0.0 -1.4749 -0.8625"
PROPS_OPTS = dict(mixed=False, tol=1e-11)


def _timed(rec, key, fn):
    t0 = time.perf_counter()
    out = fn()
    rec[key + "_s"] = time.perf_counter() - t0
    return out


def _lists(x):
    return np.asarray(x).tolist()


def props_h2o(basis):
    """Every property of dqc_tpu.api.properties on HF H2O in `basis`."""
    from dqc_tpu.api import properties as P
    rec = {"system": "H2O (CCCBDB geometry)", "basis": basis,
           "method": "HF", "moldesc": H2O_CCCBDB, "opts": PROPS_OPTS}
    mol = dqc_tpu.Mol(H2O_CCCBDB, basis=basis)
    qc = _timed(rec, "scf", lambda: dqc_tpu.HF(
        mol, opts=JOptions(**PROPS_OPTS)).run())
    rec["energy_ha"] = float(qc.energy())
    rec["hessian_pos"] = _lists(_timed(rec, "hessian_pos",
                                       lambda: P.hessian_pos(qc)))
    freqs, modes = P.vibration(qc)
    rec["freqs_cm1"] = _lists(freqs)
    rec["modes"] = _lists(modes)
    rec["ir_km_mol"] = _lists(_timed(rec, "ir", lambda: P.ir_spectrum(qc))[1])
    rec["raman_angst4_amu"] = _lists(
        _timed(rec, "raman", lambda: P.raman_spectrum(qc))[1])
    rec["edipole_au"] = _lists(_timed(rec, "edipole", lambda: P.edipole(qc)))
    rec["equadrupole_au"] = _lists(
        _timed(rec, "equadrupole", lambda: P.equadrupole(qc)))
    rec["eoctupole_au"] = _lists(
        _timed(rec, "eoctupole", lambda: P.eoctupole(qc)))
    rec["polarizability_au"] = _lists(
        _timed(rec, "polarizability", lambda: P.polarizability(qc)))
    rec["lowest_eival_orb_hessian"] = float(_timed(
        rec, "orb_hessian", lambda: P.lowest_eival_orb_hessian(qc)))
    rec["backend"] = jax.default_backend()
    print(json.dumps(rec), flush=True)


def props_small():
    """H2 geometry optimisation, a B3LYP polarizability and the
    variational energies."""
    from dqc_tpu.api import properties as P
    rec = {"opts": PROPS_OPTS}
    mol = dqc_tpu.Mol("H 0 0 0; H 1.3 0 0", basis="3-21G")
    qc = dqc_tpu.HF(mol, opts=JOptions(**PROPS_OPTS)).run()
    pos = np.asarray(_timed(rec, "optimal_geometry",
                            lambda: P.optimal_geometry(qc)))
    rec["h2_321g_optimal_geometry"] = pos.tolist()
    rec["h2_321g_optimal_bond_bohr"] = float(np.linalg.norm(pos[1] - pos[0]))
    mol = dqc_tpu.Mol("H 0 0 0; H 0 0 1.4", basis="3-21G", grid=1)
    qc = dqc_tpu.KS(mol, xc="b3lyp", opts=JOptions(**PROPS_OPTS)).run()
    rec["h2_321g_b3lyp_grid1_energy_ha"] = float(qc.energy())
    rec["h2_321g_b3lyp_grid1_polarizability_au"] = _lists(_timed(
        rec, "b3lyp_polarizability", lambda: P.polarizability(qc)))
    var = {}
    for desc, spin, params in (("H 0 0 0; H 1.0 0 0", 0,
                                ("matexp", "qr", "ov")),
                               ("H 0 0 0", 1, ("ov",))):
        mol = dqc_tpu.Mol(desc, basis="3-21g", spin=spin)
        row = {"diis_ha": float(dqc_tpu.HF(
            mol, opts=JOptions(**PROPS_OPTS)).run().energy())}
        for op in params:
            row[op + "_ha"] = float(dqc_tpu.HF(mol, opts=JOptions(
                method="variational", orb_param=op, **PROPS_OPTS)).run()
                .energy())
        var[f"{desc} spin {spin}"] = row
    rec["variational_3-21g"] = var
    rec["backend"] = jax.default_backend()
    print(json.dumps(rec), flush=True)


def main(names, factored=False):
    if "properties" in names:
        i = names.index("properties")
        names = (names[:i] + ["props_h2o_321g", "props_h2o_sto3g",
                              "props_small"] + names[i + 1:])
    if factored:
        from dqc_tpu.scf import df as jdf
        jdf.build_df_theta = factored_build_df_theta
        from dqc_tpu.scf import pbc as jpbc
        jpbc.build_pbc_gdf = factored_build_pbc_gdf
        from dqc_tpu.scf import kpbc as jkpbc
        jkpbc.build_kpbc_gdf = factored_build_kpbc_gdf
    if "batch_routes" in names:
        import test_torch_batch_routes as tb
        i = names.index("batch_routes")
        names = (names[:i] + [f"batch_{c}" for c in tb.JAX_CASES]
                 + names[i + 1:])
    for name in names:
        if name.startswith("batch_"):
            batch_route(name[len("batch_"):])
            continue
        if name == "pbc_h2_grad":
            pbc_h2_grad()
            continue
        if name.startswith("pbc_h8_"):
            pbc_h8(name, factored)
            continue
        if name.startswith("pbc_k3_"):
            _blocked_k_transforms()
            pbc_k3(name, factored)
            continue
        if name in ("props_h2o_321g", "props_h2o_sto3g"):
            props_h2o("3-21G" if name.endswith("321g") else "STO-3G")
            continue
        if name == "props_small":
            props_small()
            continue
        if name == "df_vitc":
            t0 = time.perf_counter()
            mol = dqc_tpu.Mol(VITAMIN_C, basis="cc-pvdz", grid=2).densityfit()
            opts = JOptions(mixed=False)
            qc = dqc_tpu.KS(mol, xc="lda_x+lda_c_pw", opts=opts).run()
            print(json.dumps({
                "system": "vitamin C", "basis": "cc-pvdz", "grid": 2,
                "xc": "lda_x+lda_c_pw", "route": "df", "factored": factored,
                "energy_ha": float(qc.energy()), "nao": mol.meta.nao,
                "seconds": time.perf_counter() - t0,
                "residual": getattr(qc, "_achieved_err", None),
                "tol": opts.tol, "backend": jax.default_backend()}),
                flush=True)
            continue
        df = name.startswith("df_")
        xc = resolve(name[3:] if df else name)
        t0 = time.perf_counter()
        opts = JOptions(mixed=False)
        dense_limit = jqccalc.DENSE_ERI_BYTES_LIMIT
        if get_xc(xc).exx_lr and not df:
            jqccalc.DENSE_ERI_BYTES_LIMIT = 4 * 1024 ** 3
        mol = dqc_tpu.Mol(benzene_desc(), basis="def2-svp", grid=2)
        if df:
            mol = mol.densityfit()
        qc = dqc_tpu.KS(mol, xc=xc, opts=opts).run()
        e = float(qc.energy())
        jqccalc.DENSE_ERI_BYTES_LIMIT = dense_limit
        route = ("df" if "df" in qc._theta else
                 "dense" if "eri" in qc._theta else "blocked")
        rec = {
            "system": "benzene", "basis": "def2-svp", "grid": 2, "xc": name,
            "energy_ha": e, "seconds": time.perf_counter() - t0,
            "residual": getattr(qc, "_achieved_err", None),
            "tol": opts.tol, "jk_route": route, "factored": factored,
            "backend": jax.default_backend()}
        if df:
            rec["naux"] = int(qc._theta["df"]["v_inv"].shape[0])
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    factored = "--factored" in args
    args = [a for a in args if a != "--factored"]
    main(args or ["camb3lyp", "scan", "nnxc"], factored=factored)
