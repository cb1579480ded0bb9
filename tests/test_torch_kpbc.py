"""PyTorch/CUDA port: periodic cells at k-points against the JAX package, on
the CPU.

The same cells and seeded inputs go through both packages (lengths in
Bohr, k in Bohr^-1):
  - pbc_pair_ft_k on all ordered pairs (an He2 cell with s, s and p
    shells, a two-point mesh and a general k; 1e-12 of the largest entry)
    and eval_ao_pbc_k with gradients and Laplacians (1e-12), the port's
    [Re | Im] tables against the JAX package's (re, im) pairs.
  - The real embedding of the grid kernels: rho, grad rho, lapl and tau of
    the port's KPBCEngine (K2's and K3's plain versions on the [Re | Im]
    tables, a seeded Hermitian D^k) against the JAX package's complex
    einsums (KPBCEngine._dens_of and _assemble) on the same tables, for
    LDA, GGA and meta-GGA (1e-12 relative).
  - One Fock build, energy and density from the Fock matrix on one carried
    theta in both engines (a triclinic H2 cell, two-s basis, grid 1, the
    two-point mesh; built by the port, laid out as the JAX package's
    engine reads it and read back by convert.kpbc_theta_from_numpy), for
    lda_x, pbe, mgga_x_scan, HF with exxdiv "ewald" and None, pbe0,
    camb3lyp and the k-point fit, polarized, and restricted for three of
    them (1e-12 relative; the fit 1e-11).
  - Whole SCF energies: UKS-PBE of the one-atom H cell on the two-point
    mesh (a = 3, the two-s basis, grid 1; 1e-8 Ha) and its band energies at mesh and
    off-mesh k-points against the JAX package's band_energies (1e-8 Ha).
  - The invariants of tests/test_pbc.py on the port alone: k ~ Gamma equals
    the Gamma engine (:105; 1e-10, both on the one cell's grid), HF on the
    two- and four-point meshes equals the doubled and quadrupled
    supercells at Gamma (:256, :428; 1e-6 and 5e-6 Ha per cell), and the
    polarized two-point mesh against its supercell (the :300 invariant,
    here with HF); in the two-s bases, whose G sets are small. The semilocal supercell invariants (:118, :300, :410)
    need the "sg2" wrapped grid of both cells, minutes of Becke weights on
    one core; the card runs them (chip_smoke.py's pbc_k_bloch, PBE).
  - Forces (HF and LDA, H2 in a 4-Bohr cube, two-s basis, grid 0, the
    two-point mesh) against central differences of the same energy_fn
    (1e-7 Ha/Bohr), and the Hermitian eigh_density rule against central
    differences at a degenerate level.
JAX results that several tests read are computed once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.ops import aoeval as jaoeval
from dqc_tpu.ops import pbcft as jft
from dqc_tpu.scf import kpbc as jkpbc
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu.system.sol import Sol as JSol
from dqc_tpu.xc import get_xc as jget_xc
from dqc_tpu_torch import convert
from dqc_tpu_torch.ops import aoeval as taoeval
from dqc_tpu_torch.ops import pbcft as tft
from dqc_tpu_torch.scf import kpbc as tkpbc
from dqc_tpu_torch.scf.eigh import eigh_density
from dqc_tpu_torch.scf.pbc import madelung_constant
from dqc_tpu_torch.xc import get_xc as tget_xc

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

SOFT_HE = """He     0
S    1   1.00
      1.20    1.0
S    1   1.00
      0.30    1.0
****
"""
# diffuse bases keep the G sets small: an s, s, p helium and a two-s
# hydrogen
SOFT_HE_P = SOFT_HE.replace("****", """P    1   1.00
      0.80    1.0
****""")
SOFT_H = """H     0
S    1   1.00
      0.90    1.0
S    1   1.00
      0.25    1.0
****
"""
TRICLINIC = np.array([[3.3, 0.0, 0.0], [0.5, 3.4, 0.0], [0.3, -0.4, 3.2]])
B0 = 2.0 * np.pi * np.linalg.inv(TRICLINIC).T[0]
# the two-point mesh along b1, and a general k
KMESH2 = np.stack([np.zeros(3), 0.5 * B0])
KGENERAL = np.array([[0.31, -0.17, 0.12]])
H2_KCELL = dict(soldesc="H 0.1 0.2 0.3; H 1.5 0.4 -0.2", alattice=TRICLINIC,
                basis=SOFT_H, grid=1)
HE2_KCELL = dict(H2_KCELL, soldesc="He 0.1 0.2 0.3; He 1.5 0.4 -0.2",
                 basis=SOFT_HE_P)
A = 3.0
KX2 = np.array([[0.0, 0.0, 0.0], [np.pi / A, 0.0, 0.0]])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _rel(t, j):
    t, j = _np(t), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    return np.abs(t - j).max() / max(np.abs(j).max(), 1e-300)


def _sols(kpts, **kw):
    kw = dict(kw)
    desc, a = kw.pop("soldesc"), kw.pop("alattice")
    return (dqt.Sol(desc, a, device="cpu", kpts=kpts, **kw),
            JSol(desc, a, kpts=kpts, **kw))


def _seeded_dmk(nk, n, seed, spins=0):
    """A seeded positive semidefinite Hermitian D^k = 0.3 C C^H of rank 2,
    (nk, n, n) or (spins, nk, n, n): its densities are positive, so the
    functionals see physical inputs."""
    rng = np.random.default_rng(seed)
    shape = ((spins,) if spins else ()) + (nk, n, 2)
    c = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return 0.3 * c @ np.conj(np.swapaxes(c, -1, -2))


def _split(z):
    return torch.as_tensor(np.stack([z.real, z.imag]))


# --- modules --------------------------------------------------------------

@pytest.mark.parametrize("kpts", [KMESH2, KGENERAL], ids=["mesh2", "general"])
def test_pair_ft_k_matches_jax(kpts):
    ts, js = _sols(kpts, **HE2_KCELL)
    gv, _ = js.lattice.get_gvgrids(jft.gcut_estimate(js.meta, js.params))
    g2 = np.sum(gv * gv, axis=1)
    gv = gv[g2 <= np.sort(g2)[400]]          # the inner shells: a set of +-G
    plan_t = tft.pbc_pair_plan_ordered(ts.meta, ts.params, ts.lattice)
    plan_j = jft.pbc_pair_plan_ordered(js.meta, js.params, js.lattice)
    for (_, qt, st), (_, qj, sj) in zip(plan_t, plan_j):
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_allclose(st, sj, rtol=0, atol=1e-13)
    t = tft.pbc_pair_ft_k(ts.meta, ts.params, plan_t, gv, kpts)
    j = jax.jit(lambda p: jft.pbc_pair_ft_k(js.meta, p, plan_j, gv, kpts))(
        js.params)
    scale = max(np.abs(np.asarray(j[0])).max(), np.abs(np.asarray(j[1])).max())
    for a, b in zip(t, j):
        assert np.abs(_np(a) - np.asarray(b)).max() <= 1e-12 * scale
    # Q^k(-G) = conj(Q^k(G))^T, which J and Vne use in place of a gather
    neg = jkpbc._neg_g_index(gv)
    qre, qim = _np(t[0]), _np(t[1])
    assert np.abs(qre[:, neg] - np.swapaxes(qre, -1, -2)).max() <= 1e-12 * scale
    assert np.abs(qim[:, neg] + np.swapaxes(qim, -1, -2)).max() <= 1e-12 * scale


@pytest.mark.parametrize("kpts", [KMESH2, KGENERAL], ids=["mesh2", "general"])
def test_eval_ao_pbc_k_matches_jax(kpts):
    ts, js = _sols(kpts, **HE2_KCELL)
    rng = np.random.default_rng(3)
    coords = rng.uniform(-1.0, 4.0, (200, 3))
    ls = js.lattice.get_lattice_ls(6.0)      # any set: the same in both
    t = taoeval.eval_ao_pbc_k(ts.meta, ts.params, torch.as_tensor(coords),
                              ls, kpts, deriv=2)
    j = jaoeval.eval_ao_pbc_k(js.meta, js.params, jnp.asarray(coords), ls,
                              kpts, deriv=2)
    emb = {k: np.concatenate([np.asarray(re), np.asarray(im)], axis=-1)
           for k, (re, im) in j.items()}
    assert _rel(t["ao"], emb["ao"]) < 1e-12
    assert _rel(t["ao_grad"], np.swapaxes(emb["ao_grad"], 1, 2)) < 1e-12
    assert _rel(t["ao_lapl"], emb["ao_lapl"]) < 1e-12


@pytest.mark.parametrize("xc", ["lda_x", "pbe", "mgga_x_scan"])
@pytest.mark.parametrize("polarized", [False, True], ids=["rks", "uks"])
def test_embedding_identities(xc, polarized):
    """rho, grad, lapl, tau of sum_k w_k D^k and the Hermitian V^k through
    the real embedding against the JAX package's complex einsums on the
    same Bloch tables and seeded D^k and adjoints."""
    ts, js = _sols(KMESH2, **HE2_KCELL)
    rng = np.random.default_rng(5)
    coords = rng.uniform(-1.0, 4.0, (150, 3))
    ls = js.lattice.get_lattice_ls(6.0)
    family = tget_xc(xc).family
    deriv = 0 if family <= 1 else (1 if family <= 2 else 2)
    tabs = taoeval.eval_ao_pbc_k(ts.meta, ts.params, torch.as_tensor(coords),
                                 ls, KMESH2, deriv=deriv)
    n = ts.meta.nao
    grid = dict(tabs, dvol=torch.as_tensor(rng.uniform(0.1, 1.0, 150)))

    def cplx(t):
        t = _np(t)
        return jnp.asarray(t[..., :n]), jnp.asarray(t[..., n:])
    jgrid = {"ao": cplx(tabs["ao"])}
    if deriv >= 1:
        jgrid["ao_grad"] = cplx(tabs["ao_grad"].permute(0, 2, 1, 3))
    if deriv >= 2:
        jgrid["ao_lapl"] = cplx(tabs["ao_lapl"])
    wk = np.full(2, 0.5)
    dmk = _seeded_dmk(2, n, 9, spins=2 if polarized else 0)
    teng = tkpbc.KPBCEngine(tget_xc(xc), 2, n, polarized=polarized)
    jeng = jkpbc.KPBCEngine(jget_xc(xc), 2, n, polarized=polarized)
    td = teng._dens(torch.as_tensor(dmk), {"grid": grid,
                                           "wk": torch.as_tensor(wk)})
    jd = jeng._dens(jnp.asarray(dmk), {"grid": jgrid, "wk": jnp.asarray(wk)})
    flat_t = [td["u"], td["d"]] if polarized else [td]
    flat_j = [jd["u"], jd["d"]] if polarized else [jd]
    for a, b in zip(flat_t, flat_j):
        assert set(a) == set(b)
        for key in a:
            assert _rel(a[key], b[key]) < 1e-12, key
    vbar = {key: rng.standard_normal(_np(v).shape)
            for key, v in flat_t[0].items()}
    tv = teng._assemble({k: torch.as_tensor(v) for k, v in vbar.items()},
                        grid)
    jv = jeng._assemble({k: jnp.asarray(v) for k, v in vbar.items()},
                        {"grid": jgrid})
    assert _rel(tv, jv) < 1e-12
    # and the plain version the card's path is held against
    plain = tkpbc.KPBCEngine(tget_xc(xc), 2, n)
    assert _rel(plain._assemble_plain(
        {k: torch.as_tensor(v) for k, v in vbar.items()}, grid), jv) < 1e-12


# --- Fock builds on a carried theta -----------------------------------------

@pytest.fixture(scope="module")
def carried():
    """A k-point theta of the H2 cell on the two-point mesh (family 4
    tables, exact exchange with the CAM-B3LYP omega, the k-point fit),
    built by the port and laid out as the JAX package's KPBCEngine reads
    it (complex arrays, (re, im) Bloch tables, the index of -G, the fit as
    T with v_inv = I), as numpy, with the cell. The port's engine reads it
    back through convert.kpbc_theta_from_numpy, so both engines take the
    same numbers; the modules that build it are held against the JAX
    package's above (building the JAX package's own theta eagerly takes
    minutes on one core)."""
    ts, js = _sols(KMESH2, **H2_KCELL)
    ts.densityfit(method="gdf")
    from dqc_tpu_torch.ops.shellstruct import pack_basis
    ma, pa = pack_basis(ts.dfinfo.auxbases, device="cpu")
    pa = dict(pa, atompos=ts.params["atompos"])
    mad = madelung_constant(tkpbc.kmesh_supercell(ts.lattice, KMESH2))
    omega = tget_xc("camb3lyp").exx_lr[0][1]
    ls_ao = ts.lattice.get_lattice_ls(tkpbc.estimate_rcut(
        ts.meta, ts.params, tkpbc.AO_PRECISION))
    with torch.no_grad():
        th = tkpbc.build_kpbc_theta(ts, ts.params, ts.atomzs, family=4,
                                    with_exx=True, madelung=mad,
                                    lr_omegas=(omega,), gdf_aux=(ma, pa),
                                    ls_ao=ls_ao)
    n = ts.meta.nao
    gv, _ = js.lattice.get_gvgrids(jft.gcut_estimate(js.meta, js.params))
    assert len(gv) == th["Qre"].shape[1]

    def pair(t):
        t = _np(t)
        return t[..., :n], t[..., n:]
    g = th["grid"]
    A = _np(th["exx"]["A"])
    B = _np(th["kdf"]["B"])
    jth = {"hcore": _np(th["hcore"]), "ovlp": _np(th["ovlp"]),
           "X": _np(th["X"]), "keep": _np(th["keep"]),
           "enuc": _np(th["enuc"]), "Qre": _np(th["Qre"]),
           "Qim": _np(th["Qim"]), "wcoul": _np(th["wcoul"]),
           "negG": jkpbc._neg_g_index(gv), "wk": _np(th["wk"]),
           "grid": {"dvol": _np(g["dvol"]), "ao": pair(g["ao"]),
                    "ao_grad": pair(g["ao_grad"].permute(0, 2, 1, 3)),
                    "ao_lapl": pair(g["ao_lapl"])},
           "exx": {"Are": A.real, "Aim": A.imag,
                   "wq": _np(th["exx"]["wq"]),
                   "wqsr0": _np(th["exx"]["wqsr0"]),
                   "madelung": th["exx"]["madelung"]},
           "kdf": {"Tre": B.real, "Tim": B.imag,
                   "v_inv": np.eye(B.shape[-1])}}
    return js, jth


def _carried_theta(js, th, case, polarized):
    """The JAX theta of one case and the port's, carried across."""
    xc = "hf" if case.startswith("hf") else case.replace("gdf_", "")
    jth = {k: v for k, v in th.items() if k not in ("exx", "kdf")}
    jx = jget_xc(xc)
    if jx.exx_fraction != 0.0 or jx.exx_lr:
        jth["exx"] = dict(th["exx"], madelung=None) if case == "hf_none" \
            else th["exx"]
    if case.startswith("gdf"):
        jth["kdf"] = th["kdf"]
    # two electrons: one up and one down, or one doubly occupied orbital
    jth["occ"] = (np.stack([np.r_[1.0, np.zeros(3)]] * 2) if polarized
                  else np.r_[2.0, np.zeros(3)])
    tth = convert.kpbc_theta_from_numpy(jth, device="cpu")
    tth["xc_params"] = None
    jjth = jax.tree_util.tree_map(
        lambda x: x if x is None else jnp.asarray(x), jth,
        is_leaf=lambda x: x is None)
    jjth["xc_params"] = None
    return xc, jjth, tth


CASES = [("lda_x", True), ("pbe", True), ("mgga_x_scan", True),
         ("hf_ewald", True), ("hf_none", True), ("pbe0", True),
         ("camb3lyp", True), ("gdf_pbe", True), ("pbe", False),
         ("hf_ewald", False), ("camb3lyp", False)]


@pytest.mark.parametrize("case,polarized", CASES,
                         ids=[f"{c}-{'uks' if p else 'rks'}" for c, p in CASES])
def test_fock_on_carried_theta(carried, case, polarized):
    js, th = carried
    xc, jth, tth = _carried_theta(js, th, case, polarized)
    n, nk = js.meta.nao, 2
    dmk = _seeded_dmk(nk, n, 21, spins=2 if polarized else 0)
    teng = tkpbc.KPBCEngine(tget_xc(xc), nk, n, polarized=polarized)
    jeng = jkpbc.KPBCEngine(jget_xc(xc), nk, n, polarized=polarized)
    x = _split(dmk)
    tf = tkpbc.join(teng.fock(x, tth))
    jf = jeng.fock(jnp.asarray(dmk), jth)
    tol = 1e-11 if case.startswith("gdf") else 1e-12
    assert _rel(tf, jf) < tol
    te = float(teng.energy(x, tth))
    je = float(jeng.energy(jnp.asarray(dmk), jth))
    assert abs(te - je) < tol * max(1.0, abs(je))
    # the density from a Fock matrix: the same D^k
    td = tkpbc.join(teng.dm_from_fock(_split(np.asarray(jf)), tth))
    jdm = jeng.dm_from_fock(jf, jth)
    assert _rel(td, jdm) < 1e-10


# --- whole SCF energies and band energies -----------------------------------

@pytest.fixture(scope="module")
def h_uks_pbe():
    ts, js = _sols(KX2, soldesc="H 0 0 0", alattice=np.eye(3) * A,
                   basis=SOFT_H, spin=1, grid=1)
    tq = dqt.KS(ts, xc="pbe").run()
    jq = dqc_tpu.KS(js, xc="pbe", opts=JOptions(mixed=False)).run()
    return tq, jq


def test_scf_energy_matches_jax(h_uks_pbe):
    tq, jq = h_uks_pbe
    assert abs(float(tq.energy()) - float(jq.energy())) < 1e-8
    assert tq.stats["residual"] <= tq.opts.tol
    assert tq.stats["guess"] == "core" and tq.stats["nk"] == 2
    dm = tq.aodm()
    assert dm.u.is_complex() and tuple(dm.u.shape) == (2, 2, 2)


def test_band_energies_match_jax(h_uks_pbe):
    tq, jq = h_uks_pbe
    # two band points, the mesh's own count: the JAX package's band path
    # reuses the shapes its SCF compiled
    kb = np.array([KX2[1], [0.5 * np.pi / A, 0.1, 0.0]])
    tb = dqt.band_energies(tq, kb)
    jb = jkpbc.band_energies(jq, kb)
    assert tuple(tb.shape) == (2, 2, 2)
    assert np.abs(_np(tb) - np.asarray(jb)).max() < 1e-8
    # at a mesh point: the SCF's own eigenvalues
    eng, th = tq.engine, tq._theta
    eps = eng.eigenvalues(eng.fock(tq._dm, th), th)
    assert np.abs(_np(tb[:, 0]) - _np(eps[:, 1])).max() < 1e-10


# --- invariants of tests/test_pbc.py on the port ------------------------------

def test_kpoint_gamma_matches_gamma_engine():
    """k ~ Gamma gives the Gamma engine's energy (tests/test_pbc.py:105).
    The rule of both packages sends |k| <= 1e-12 to the Gamma engine, so
    that test's k = 1e-13 runs the Gamma path twice; here k = 1e-9 takes
    the k-point engine."""
    assert not tkpbc.has_kpoints([[1e-13, 0.0, 0.0]])
    kw = dict(basis="sto-3g", grid=1, device="cpu")
    e_g = float(dqt.KS(dqt.Sol("He 0 0 0", np.eye(3) * A, **kw),
                       xc="lda_x").run().energy())
    qk = dqt.KS(dqt.Sol("He 0 0 0", np.eye(3) * A,
                        kpts=np.array([[1e-9, 0.0, 0.0]]), **kw),
                xc="lda_x").run()
    assert isinstance(qk.engine, tkpbc.KPBCEngine)
    assert abs(float(qk.energy()) - e_g) < 1e-10


@pytest.mark.parametrize("nk,tol", [(2, 1e-6), (4, 5e-6)])
def test_kpoint_hf_supercell_invariant(nk, tol):
    """HF on an nk-point mesh of the He cell equals the nk-fold supercell
    at Gamma, per cell (tests/test_pbc.py:256, :428)."""
    kx = 2.0 * np.pi / (nk * A) * np.arange(nk)
    kpts = np.stack([kx, np.zeros(nk), np.zeros(nk)], axis=-1)
    e_k = float(dqt.HF(dqt.Sol("He 0 0 0", np.eye(3) * A, basis=SOFT_HE,
                               kpts=kpts, device="cpu")).run().energy())
    desc = "; ".join(f"He {n * A} 0 0" for n in range(nk))
    e_sc = float(dqt.HF(dqt.Sol(desc, np.diag([nk * A, A, A]),
                                basis=SOFT_HE, device="cpu")).run().energy())
    assert abs(e_k - e_sc / nk) < tol


def test_kpoint_polarized_supercell_invariant():
    """The polarized k-point engine: the ferromagnetic H chain, one up
    electron per cell on the two-point mesh, equals the doubled cell with
    spin 2 at Gamma (the invariant of tests/test_pbc.py:300, with HF)."""
    e_k = float(dqt.HF(dqt.Sol("H 0 0 0", np.eye(3) * A, basis=SOFT_H,
                               spin=1, kpts=KX2,
                               device="cpu")).run().energy())
    e_sc = float(dqt.HF(dqt.Sol(f"H 0 0 0; H {A} 0 0", np.diag([2 * A, A, A]),
                                basis=SOFT_H, spin=2,
                                device="cpu")).run().energy())
    assert abs(e_k - e_sc / 2) < 5e-6


# --- derivatives ---------------------------------------------------------------

@pytest.mark.parametrize("xc", [None, "lda_x"], ids=["hf", "lda"])
def test_kpoint_forces_match_central_differences(xc):
    sol = dqt.Sol("H 0.1 -0.05 0.02; H 1.45 0.12 -0.1", np.eye(3) * 4.0,
                  basis=SOFT_H, grid=0, device="cpu",
                  kpts=np.array([[0.0, 0.0, 0.0], [np.pi / 4.0, 0.0, 0.0]]))
    qc = (dqt.HF(sol) if xc is None else dqt.KS(sol, xc=xc)).run()
    g = qc.energy_grad()["basis"]["atompos"]
    assert abs(float(g.sum(0).abs().max())) < 1e-8
    p0 = qc._all_params()
    pos0 = p0["basis"]["atompos"]
    h = 1e-4
    for atom, axis in ((1, 0),):
        es = []
        for sgn in (1, -1):
            pos = pos0.clone()
            pos[atom, axis] += sgn * h
            with torch.no_grad():
                es.append(float(qc.energy_fn(
                    dict(p0, basis=dict(p0["basis"], atompos=pos)))))
        assert abs((es[0] - es[1]) / (2 * h) - float(g[atom, axis])) < 1e-7


def test_hermitian_eigh_density_rule_at_a_degenerate_level():
    """P = V diag(occ) V^H of a complex Hermitian matrix with a doubly
    degenerate occupied level: the rule's derivative along a Hermitian
    direction against central differences, and 0 (to the rounding of the
    two basis changes) inside the degenerate pair of equal occupation."""
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.standard_normal((4, 4))
                        + 1j * rng.standard_normal((4, 4)))
    a0 = (q * np.array([-1.0, -1.0, 0.5, 2.0])) @ q.conj().T
    d = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    d = d + d.conj().T
    occ = torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    pbar = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    pbar = torch.as_tensor(pbar + pbar.conj().T)
    a = torch.as_tensor(a0).requires_grad_(True)
    p, _, _ = eigh_density(a, occ)
    (abar,) = torch.autograd.grad((p * pbar.conj()).sum().real, a)
    h = 1e-6

    def loss(m):
        pm, _, _ = eigh_density(torch.as_tensor(m), occ)
        return float((pm * pbar.conj()).sum().real)
    fd = (loss(a0 + h * d) - loss(a0 - h * d)) / (2 * h)
    assert abs(float((abar.conj() * torch.as_tensor(d)).sum().real) - fd) \
        < 1e-7
    # inside the degenerate occupied pair the rule is exactly zero
    w, v = torch.linalg.eigh(torch.as_tensor(a0))
    g = v.mH @ abar @ v
    assert max(float(g[0, 1].abs()), float(g[1, 0].abs())) \
        <= 1e-14 * float(g.abs().max())
