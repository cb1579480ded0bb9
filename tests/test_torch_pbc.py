"""PyTorch/CUDA port: periodic cells at the Gamma point against the JAX
package, on the CPU.

The same cells go through both packages (all lengths in Bohr):
  - Lattice and ewald_energy: the CsCl and NaCl Madelung constants of
    tests/test_pbc.py, the JAX package's energies and position gradients of
    seeded cells (1e-12), its enumerations of translations and G vectors.
  - pbc_overlap and pbc_kinetic at Gamma and at a k-point (1e-12), and
    their isolated limit (the molecular integrals, 1e-9).
  - pbc_pair_ft: F(G = 0) = S, and the JAX package's F on the whole G set of
    an He2 cell with s and p shells (1e-12 of the largest entry);
    eval_ao_ft (1e-12).
  - aft_j, aft_k and aft_k_weighted on a seeded dm, on the JAX package's
    own pair transforms (1e-12 relative); madelung_constant.
  - pbc_wrap_grid: every array equal; setup_pbc_grid_theta: coords, dvol,
    ao and ao_grad of the one-atom H cell (1e-12); chunked Becke weights
    equal to the whole, on a molecule, and the in-place path's bits equal
    to the autograd path's.
  - SCF energies: UKS PBE of the one-atom H cell (a = 3, 3-21G, sg2; the
    JAX package gives -0.874879927276 Ha) and HF of He/SOFT_HE (a = 5), both
    1e-9 Ha.
  - Fock builds on a theta and dm carried across from the JAX package
    (one-atom H cell, polarized): HF with exxdiv "ewald" and None, PBE0,
    CAM-B3LYP (long range as full minus short range on wsr0), and the
    periodic fit with its short-range fit df_sr0 (the JAX package's fit
    contracted in factored form, torch_anchor_report.factored_build_pbc_gdf:
    its explicit v_inv loses eps * cond to cancellation; 1e-11 relative);
    others 1e-12 relative.
  - The port's forces (HF and LDA, H2 in a 5-Bohr cube) against central
    differences of its own energy_fn (1e-7), and the k-point entry points
    (a cell with k-points builds a calc on the k-point engine).
Each JAX result is computed once per module (fixtures).
"""
import jax
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.grid import becke as jbecke
from dqc_tpu.ops import pbc as jpbc
from dqc_tpu.ops import pbcft as jft
from dqc_tpu.scf import engine as jengine
from dqc_tpu.scf import pbc as jspbc
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu.system import lattice as jlat
from dqc_tpu.system.sol import Sol as JSol
from dqc_tpu.xc import get_xc as jget_xc
from dqc_tpu_torch import convert
from dqc_tpu_torch.grid import becke as tbecke
from dqc_tpu_torch.ops import pbcft as tft
from dqc_tpu_torch.scf import engine as tengine
from dqc_tpu_torch.scf import pbc as tspbc
from dqc_tpu_torch.system import lattice as tlat
from dqc_tpu_torch.utils import config as tconfig
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
# diffuse bases keep the G sets small: an s, s, p helium (pair transforms up
# to L = 2) and a two-s hydrogen
SOFT_HE_P = SOFT_HE.replace("****", """P    1   1.00
      0.80    1.0
****""")
SOFT_H = SOFT_HE.replace("He", "H ").replace("1.20", "0.90").replace(
    "0.30", "0.25")
# H2 in a 5-Bohr cube, two-s SOFT_H, grid 0: the force tests' cell
H2_FORCE_CELL = dict(soldesc="H 0 0 0; H 1.5 0 0", alattice=np.eye(3) * 5.0,
                     basis=SOFT_H, grid=0)
# jax.grad of the JAX package's energy_fn of H2_FORCE_CELL in the atom
# positions, SCF tol 1e-12 (tests/torch_anchor_report.py pbc_h2_grad),
# Ha/Bohr
JAX_H2_GRAD = {
    None: [[0.11774997532968981, 1.4586800902602298e-18,
            1.2265535830428695e-18],
           [-0.11774997532968975, 5.9952805395933266e-18,
            -5.310995612878037e-18]],
    "lda_x": [[0.1143349251606506, 2.0076469363027196e-05,
               2.824607975034911e-05],
              [-0.11433492516064978, -2.0076469363006024e-05,
               -2.8246079750364146e-05]]}
H_CELL = dict(soldesc="H 0 0 0", alattice=np.eye(3) * 3.0, basis="3-21g",
              spin=1, grid="sg2")
H2_CELL = dict(soldesc="H 0.1 0.2 0.3; H 1.5 0.4 -0.2",
               alattice=np.array([[3.3, 0.0, 0.0], [0.5, 3.4, 0.0],
                                  [0.3, -0.4, 3.2]]), basis="3-21g")
HE2_CELL = dict(H2_CELL, soldesc="He 0.1 0.2 0.3; He 1.5 0.4 -0.2",
                basis=SOFT_HE_P)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(t, j):
    t, j = _np(t), np.asarray(j)
    assert t.shape == j.shape
    return np.abs(t - j).max() / max(np.abs(j).max(), 1e-300)


def _sols(**kw):
    kw = dict(kw)
    desc, a = kw.pop("soldesc"), kw.pop("alattice")
    return dqt.Sol(desc, a, device="cpu", **kw), JSol(desc, a, **kw)


def _seeded_dm(n, seed, spins=0):
    rng = np.random.default_rng(seed)
    shape = (spins, n, n) if spins else (n, n)
    dm = rng.standard_normal(shape)
    return dm + np.swapaxes(dm, -1, -2)


# --- lattice and Ewald ------------------------------------------------------

@pytest.mark.parametrize("case", ["cscl", "nacl"])
def test_ewald_madelung_constants(case):
    a = 2.0
    if case == "cscl":
        lat = np.eye(3) * a
        pos = np.array([[0.0, 0, 0], [a / 2, a / 2, a / 2]])
        r_nn, ref = np.sqrt(3) * a / 2, 1.76267477
    else:
        lat = np.array([[0.0, a, a], [a, 0.0, a], [a, a, 0.0]])
        pos = np.array([[0.0, 0, 0], [a, a, a]])
        r_nn, ref = a, 1.74756459
    e = float(tlat.ewald_energy(np.array([1.0, -1.0]), pos, tlat.Lattice(lat)))
    assert abs(-e * r_nn - ref) < 1e-6
    ej = float(jlat.ewald_energy(np.array([1.0, -1.0]), pos,
                                 jlat.Lattice(lat)))
    assert abs(e - ej) < 1e-12


@pytest.mark.parametrize("seed", [0, 1])
def test_ewald_energy_and_gradient_match_jax(seed):
    rng = np.random.default_rng(seed)
    lat = np.eye(3) * 4.0 + 0.3 * rng.standard_normal((3, 3))
    pos = rng.uniform(0, 4, (3, 3))
    z = np.array([1.0, 2.0, 3.0])
    tl, jl = tlat.Lattice(lat), jlat.Lattice(lat)
    p = torch.tensor(pos, requires_grad=True)
    e = tlat.ewald_energy(z, p, tl)
    (g,) = torch.autograd.grad(e, p)
    ej, gj = jax.jit(jax.value_and_grad(
        lambda x: jlat.ewald_energy(z, x, jl)))(jax.numpy.asarray(pos))
    assert abs(float(e) - float(ej)) < 1e-12 * max(1.0, abs(float(ej)))
    assert _rel(g, gj) < 1e-11
    for rcut in (5.0, 9.5):
        np.testing.assert_array_equal(tl.get_lattice_ls(rcut),
                                      jl.get_lattice_ls(rcut))
    for x, y in zip(tl.get_gvgrids(4.0), jl.get_gvgrids(4.0)):
        np.testing.assert_array_equal(x, y)
    assert _rel(tl.recip_vectors(), jl.recip_vectors()) < 1e-14
    assert abs(float(tl.volume()) - float(jl.volume())) < 1e-12


@pytest.mark.parametrize("L", [4.0, 7.5])
def test_madelung_constant(L):
    m = tspbc.madelung_constant(tlat.Lattice(np.eye(3) * L))
    assert abs(m - 2.8372974794806 / L) < 1e-9
    assert abs(m - jspbc.madelung_constant(jlat.Lattice(np.eye(3) * L))) \
        < 1e-13


# --- one-electron lattice sums and pair transforms ---------------------------

@pytest.mark.parametrize("kind", ["overlap", "kinetic"])
def test_lattice_sums_match_jax_at_gamma_and_a_kpoint(kind):
    kpts = np.array([[0.0, 0.0, 0.0], [0.1, 0.2, -0.3]])
    ts, js = _sols(**H2_CELL, kpts=kpts)
    t = getattr(ts, f"pbc_{kind}")()
    ls = js.lattice.get_lattice_ls(jpbc.estimate_rcut(js.meta, js.params,
                                                      1e-10))
    j = np.asarray(jax.jit(lambda p: getattr(jpbc, f"pbc_{kind}")(
        js.meta, p, ls, kpts))(js.params))
    assert t.dtype == torch.complex128 and t.shape == j.shape
    assert np.abs(_np(t) - j).max() < 1e-12
    np.testing.assert_allclose(_np(t)[1], _np(t)[1].conj().T, atol=1e-13)


def test_lattice_sums_isolated_limit():
    from dqc_tpu_torch.ops import integrals as I
    sol = dqt.Sol("H 0 0 0; H 1.4 0 0", np.eye(3) * 30.0, basis="sto-3g",
                  device="cpu")
    for kind, mol_fn in (("overlap", I.overlap), ("kinetic", I.kinetic)):
        m = getattr(sol, f"pbc_{kind}")()[0]
        assert torch.abs(m.imag).max() < 1e-12
        assert _rel(m.real, _np(mol_fn(sol.meta, sol.params))) < 1e-9


@pytest.fixture(scope="module")
def he2_cell():
    """The pair transforms of an He2 cell with s and p shells in both
    packages, and a theta of the JAX package's transforms with a Madelung
    term and one short-range weight."""
    ts, js = _sols(**HE2_CELL)
    gv, _ = js.lattice.get_gvgrids(jft.gcut_estimate(js.meta, js.params))
    tplan = tft.pbc_pair_plan(ts.meta, ts.params, ts.lattice)
    jplan = jft.pbc_pair_plan(js.meta, js.params, js.lattice)
    tF = tft.pbc_pair_ft(ts.meta, ts.params, tplan, gv)
    jF = jax.jit(lambda p: jft.pbc_pair_ft(js.meta, p, jplan, gv))(js.params)
    vol = js.lattice.volume()
    jth = {"ovlp": _np(ts.pbc_overlap()[0].real),
           "pbcft": {"Fre": jF[0], "Fim": jF[1],
                     "wcoul": jft.coulomb_gweights(gv, vol), "madelung": 0.37,
                     "wsr0": jft.coulomb_gweights_sr(gv, vol, 0.4)}}
    return ts, js, gv, tplan, jplan, tF, jF, jth


def test_pair_plan_and_pair_ft_match_jax(he2_cell):
    ts, js, gv, tplan, jplan, tF, jF, _ = he2_cell
    for (tpc, tq, tsh), (jpc, jq, jsh) in zip(tplan, jplan):
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(tsh, jsh)
    for t, j in zip(tF, jF):
        assert np.abs(_np(t) - np.asarray(j)).max() < 1e-12 * np.abs(
            np.asarray(jF[0])).max()
    # F(G = 0) is the lattice-summed overlap
    S = ts.pbc_overlap(1e-12)[0].real
    plan = tft.pbc_pair_plan(ts.meta, ts.params, ts.lattice, 1e-12)
    F0 = tft.pbc_pair_ft(ts.meta, ts.params, plan, np.zeros((1, 3)))
    assert _rel(F0[0][0], S) < 1e-9 and torch.abs(F0[1][0]).max() < 1e-12


@pytest.mark.parametrize("block_bytes", [None, 400_000])
def test_pair_ft_blocks_and_repeats(he2_cell, monkeypatch, block_bytes):
    """A second build gives the same bits; cut into many G blocks, the same
    numbers."""
    ts, _, gv, tplan, _, tF, _, _ = he2_cell
    if block_bytes:
        monkeypatch.setitem(tconfig.PBC_BLOCK_BYTES, "cpu", block_bytes)
    again = tft.pbc_pair_ft(ts.meta, ts.params, tplan, gv)
    for a, b in zip(again, tF):
        if block_bytes is None:
            assert torch.equal(a, b)
        else:
            assert _rel(a, _np(b)) < 1e-14


def test_eval_ao_ft_matches_jax():
    from dqc_tpu.ops.pbcft import eval_ao_ft
    mt = dqt.Mol("C 0.1 0 0; H 1.2 0.3 0", basis="3-21g", device="cpu")
    mj = dqc_tpu.Mol("C 0.1 0 0; H 1.2 0.3 0", basis="3-21g")
    gv = np.random.default_rng(3).standard_normal((40, 3)) * 2.0
    jft_ao = jax.jit(lambda p: eval_ao_ft(mj.meta, p, gv))(mj.params)
    for t, j in zip(tft.eval_ao_ft(mt.meta, mt.params, gv), jft_ao):
        assert np.abs(_np(t) - np.asarray(j)).max() < 1e-12


@pytest.mark.parametrize("what", ["aft_j", "aft_k", "aft_k_weighted"])
@pytest.mark.parametrize("spins", [0, 2])
def test_aft_contractions_on_jax_transforms(he2_cell, what, spins):
    _, _, _, _, _, _, _, jth = he2_cell
    th = convert.theta_from_numpy(jax.tree_util.tree_map(np.asarray, jth),
                                  device="cpu")
    n = th["ovlp"].shape[0]
    dm = _seeded_dm(n, 5, spins)
    if what == "aft_j":
        d = dm.sum(0) if spins else dm
        t, j = (tft.aft_j(th["pbcft"], torch.as_tensor(d)),
                jft.aft_j(jth["pbcft"], d))
    elif what == "aft_k":
        t, j = tft.aft_k(th, torch.as_tensor(dm)), jft.aft_k(jth, dm)
    else:
        t = tft.aft_k_weighted(th["pbcft"], torch.as_tensor(dm),
                               th["pbcft"]["wsr0"])
        j = jft.aft_k_weighted(jth["pbcft"], dm, jth["pbcft"]["wsr0"])
    assert _rel(t, j) < 1e-12


# --- the wrapped grid --------------------------------------------------------

def test_chunked_becke_equals_whole_on_a_molecule(monkeypatch):
    mol = dqt.Mol("O 0 0 0.22; H 0 1.43 -0.89; H 0 -1.43 -0.89",
                  basis="sto-3g", grid=1, device="cpu")
    g = mol.setup_grid()
    pos = mol.params["atompos"]
    coords = pos[torch.as_tensor(g.atom_idx.astype(np.int64))] + \
        torch.as_tensor(g.ratom)[:, None] * torch.as_tensor(g.dirs)
    idx = torch.as_tensor(g.atom_idx.astype(np.int64))
    radii = torch.as_tensor(g.atom_radii)
    whole = tbecke.becke_weights(coords, idx, pos, radii)
    # a byte budget of 97 points per chunk (3 arrays of 3 x 3 doubles each)
    monkeypatch.setitem(tconfig.PBC_BLOCK_BYTES, "cpu", 97 * 8 * 3 * 9)
    assert len(coords) > 3 * 97
    assert torch.equal(tbecke.becke_weights(coords, idx, pos, radii), whole)
    # chunks recomputed under checkpoint (autograd on): the same bits
    p = pos.clone().requires_grad_(True)
    assert torch.equal(tbecke.becke_weights(coords, idx, p,
                                            radii).detach(), whole)
    wj = jbecke.becke_weights(np.asarray(coords), np.asarray(idx),
                              np.asarray(pos), np.asarray(radii))
    assert _rel(whole, wj) < 1e-13


@pytest.fixture(scope="module")
def h_pbe():
    """UKS PBE of the one-atom H cell in both packages (the port's run and
    the JAX package's, each with its theta)."""
    ts, js = _sols(**H_CELL)
    tq = dqt.KS(ts, xc="pbe").run()
    jq = dqc_tpu.KS(js, xc="pbe", opts=JOptions(mixed=False)).run()
    return ts, js, tq, jq


def test_pbc_wrap_grid_matches_jax(h_pbe):
    ts, js, _, _ = h_pbe
    tg, jg = ts.setup_grid(), js.setup_grid()
    for f in ("ratom", "dirs", "w0", "atom_idx", "shift", "vatom_idx",
              "vowner", "vshift", "atom_radii"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))


@pytest.mark.parametrize("key", ["coords", "dvol", "ao", "ao_grad"])
def test_grid_theta_matches_jax(h_pbe, key):
    _, _, tq, jq = h_pbe
    t, j = tq._theta["grid"][key], np.asarray(jq._theta["grid"][key])
    if key == "ao_grad":
        j = np.moveaxis(j, 1, 0)           # the JAX package's (ng, 3, nao)
    assert _rel(t, j) < 1e-12
    if key == "dvol":                      # the cell's volume
        assert abs(float(t.sum()) - 27.0) < 1e-2


def test_uks_pbe_energy_matches_jax(h_pbe):
    _, _, tq, jq = h_pbe
    assert abs(float(tq.energy()) - float(jq.energy())) < 1e-9
    assert abs(float(tq.energy()) - (-0.874879927276)) < 1e-9
    assert tq.jk_mode == "aft" and tq.stats["guess"] == "core"
    assert "madelung" in tq._theta["pbcft"]
    assert tq._theta["pbcft"]["madelung"] is None     # PBE forms no K


def test_hf_energy_matches_jax():
    ts, js = _sols(soldesc="He 0 0 0", alattice=np.eye(3) * 5.0,
                   basis=SOFT_HE)
    et = float(dqt.HF(ts).run().energy())
    ej = float(dqc_tpu.HF(js, opts=JOptions(mixed=False)).run().energy())
    assert abs(et - ej) < 1e-9


@pytest.mark.parametrize("case", ["hf_ewald", "hf_none", "pbe0", "camb3lyp",
                                  "gdf_camb3lyp"])
def test_fock_on_carried_theta(h_pbe, case):
    """One Fock build and energy of each route on a theta and a polarized dm
    carried across from the JAX package."""
    ts, js, _, jq = h_pbe
    xc = None if case.startswith("hf") else case.replace("gdf_", "")
    mad = (None if case == "hf_none"
           else jspbc.madelung_constant(js.lattice))
    omegas = () if xc is None else tuple(w for _, w in jget_xc(xc).exx_lr)
    gv, _ = js.lattice.get_gvgrids(jft.gcut_estimate(js.meta, js.params))
    vol = js.lattice.volume()
    # the JAX package's theta of its PBE run, with this case's Madelung
    # term and short-range weights (build_pbc_core_theta's keys)
    base = jq._theta
    pb = dict(base["pbcft"], madelung=mad)
    for i, w in enumerate(omegas):
        pb[f"wsr{i}"] = jft.coulomb_gweights_sr(gv, vol, w)
    jth = {k: base[k] for k in ("hcore", "ovlp", "X", "keep", "enuc", "occ")}
    jth["pbcft"] = pb
    if case.startswith("gdf"):
        # the JAX package's fit contracted in factored form, as the port's
        # (its explicit v_inv loses eps * cond to cancellation, queue C)
        from dqc_tpu.ops.shellstruct import pack_basis as jpack
        from torch_anchor_report import factored_build_pbc_gdf
        ma, pa = jpack(js.densityfit(method="gdf").dfinfo.auxbases)
        pa = dict(pa, atompos=js.params["atompos"])
        del jth["pbcft"]
        jth["df"] = factored_build_pbc_gdf(
            pb["Fre"], pb["Fim"], pb["wcoul"], ma, pa, gv, madelung=mad,
            ovlp=base["ovlp"])
        jth["df_sr0"] = factored_build_pbc_gdf(
            pb["Fre"], pb["Fim"], pb["wsr0"], ma, pa, gv)
    if xc is not None:
        jth["grid"] = base["grid"]
        jth["xc_params"] = None
    jnp_th = jax.tree_util.tree_map(
        lambda x: x if x is None else np.asarray(x), jth,
        is_leaf=lambda x: x is None)
    th = convert.theta_from_numpy(jnp_th, device="cpu")
    if xc is not None:
        g = jnp_th["grid"]
        th["grid"] = convert.grid_theta_from_numpy(
            g["coords"], g["dvol"], g["ao"], np.moveaxis(g["ao_grad"], 1, 0),
            device="cpu")
    n = ts.meta.nao
    dm = _seeded_dm(n, 11, spins=2) * 0.3
    if xc is None:
        teng, jeng = tengine.HFEngine(True), jengine.HFEngine(True)
    else:
        teng = tengine.KSEngine(tget_xc(xc), polarized=True)
        jeng = jengine.KSEngine(jget_xc(xc), polarized=True)
    tf = teng.fock(torch.as_tensor(dm), th)
    jf = jeng.fock(jax.numpy.asarray(dm), jth)
    tol = 1e-11 if case.startswith("gdf") else 1e-12
    assert _rel(tf, jf) < tol
    te = float(teng.energy(torch.as_tensor(dm), th))
    je = float(jeng.energy(jax.numpy.asarray(dm), jth))
    assert abs(te - je) < tol * max(1.0, abs(je))


# --- derivatives and probes --------------------------------------------------

@pytest.fixture(scope="module", params=[None, "lda_x"])
def h2_force(request):
    """The port's HF or LDA calc of the H2 force cell and its energy_grad
    in the atom positions."""
    xc = request.param
    sol = dqt.Sol(device="cpu", **H2_FORCE_CELL)
    opts = dqt.SCFOptions(tol=1e-12)
    qc = (dqt.HF(sol, opts=opts) if xc is None
          else dqt.KS(sol, xc=xc, opts=opts))
    return xc, qc, qc.energy_grad()["basis"]["atompos"]


def test_forces_match_central_differences(h2_force):
    """The port's energy_grad of a periodic cell against central
    differences of its own energy_fn (the grid's wrapping and images are
    frozen, so the same function on both sides; tests/test_pbc.py:363)."""
    _, qc, g = h2_force
    p0 = qc._all_params()
    h = 1e-4
    es = []
    for sgn in (1, -1):
        pos = p0["basis"]["atompos"].clone()
        pos[1, 0] += sgn * h
        with torch.no_grad():
            es.append(float(qc.energy_fn(dict(p0, basis=dict(
                p0["basis"], atompos=pos)))))
    assert abs(float(g[1, 0]) - (es[0] - es[1]) / (2 * h)) < 1e-7
    assert abs(float(g.sum(0)[0])) < 1e-8


def test_forces_match_jax_grad(h2_force):
    """The same gradient against jax.grad of the JAX package's periodic
    energy_fn (its grid statics frozen the same way), stored in
    JAX_H2_GRAD: 1e-11 Ha/Bohr."""
    xc, _, g = h2_force
    assert np.abs(g.numpy() - np.array(JAX_H2_GRAD[xc])).max() <= 1e-11


def test_kpoints_and_probes():
    from dqc_tpu_torch.scf.kpbc import KPBCEngine
    sol = dqt.Sol("He 0 0 0", np.eye(3) * 3.0, basis="sto-3g",
                  kpts=np.array([[0.0, 0, 0], [0.5, 0, 0]]), device="cpu")
    # a cell with k-points builds a calc on the k-point engine
    for calc in (dqt.KS(sol, xc="lda_x"), dqt.HF(sol)):
        assert isinstance(calc.engine, KPBCEngine) and calc.engine.nk == 2
    assert dqt.HF(sol).engine.has_exx and not dqt.HF(sol).engine.semilocal
    with pytest.raises(ValueError, match="kpts"):
        dqt.Sol("He 0 0 0", np.eye(3) * 3.0, kpts=[0.0, 0.0, 0.0],
                device="cpu")
    # the on-disk theta cache is ported: set_cache returns the cell
    assert sol.set_cache("x") is sol and sol._cache_fname == "x"
    assert sol.cache_signature.startswith("sol-")
    assert sol.densityfit() is sol and sol.dfinfo is None
    assert sol.densityfit(method="gdf").dfinfo.method == "gdf"
    assert sol.densityfit(method="coulomb").dfinfo.method == "gdf"
    with pytest.raises(ValueError, match="coulomb"):
        sol.densityfit(method="ri")
    assert sol.efield is None and sol.vext is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dqt.Sol("He 0 0 0", np.eye(3) * 3.0)
