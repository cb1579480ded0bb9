"""PyTorch/CUDA port: density fitting against the JAX package, on the CPU.

The same molecules and aux bases go through both packages:
  - autoaux: the same shells, exponents and order (exact).
  - register_basis_dir and the directory lookup, on a Gaussian94 file the
    test writes: both loaders read the same file.
  - coul2c and coul3c, with and without omega, on H2O/STO-3G and 3-21G:
    1e-12 relative to the largest entry.
  - df_j and df_k, the contractions alone, on the JAX package's j3c and a
    seeded well-conditioned v_inv: 1e-12 relative, restricted and
    polarized.
  - build_df_theta: the port factors the Coulomb metric by Cholesky and
    takes the square root of the pseudo-inverse of the attenuated one (the
    JAX package's eigh pseudo-inverse, eigenvalues above 1e-12 of the
    largest kept). Held at the converged DF HF density to 1e-11 relative
    against numpy's factored form of the same function on the JAX
    package's integrals. The JAX package's own df_j/df_k contract with the
    explicit v_inv and lose about eps * cond(j2c) to cancellation: 4.5e-10
    relative in J (Coulomb metric, ratio 3.2e-9) and 1.5e-6 in K (omega =
    0.5) on H2O/STO-3G, 2.0e-9 Ha and 3.9e-6 Ha in the energy at a fixed
    dm (ROADMAP queue C). Measured bounds of that fault are held too.
  - SCF energies (HF, RKS-PBE, UKS-LDA, LC-LDA with its attenuated-metric
    fit) on H2O/STO-3G grid 1 at tol 1e-11 in both packages, the JAX
    package's fit contracted in factored form (its SCF, integrals, grid and
    XC unchanged): 1e-9 Ha.
  - The DF gradient in atompos against jax.grad of the JAX package's
    energy_fn (polarized PBE, tests/test_adjoint.py::
    test_adjoint_polarized_df): 1e-9.
  - Port only: an energy HVP against central differences of energy_grad;
    the mirror symmetry of benzene/STO-3G DF forces; the metric-ratio
    raise; Mol.densityfit; what theta and stats hold on the DF route.
Each JAX result is computed once per process (lru_cache).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.basis import autoaux as jautoaux
from dqc_tpu.basis import loader as jloader
from dqc_tpu.ops import eri as jeri
from dqc_tpu.ops.shellstruct import pack_basis as jpack
from dqc_tpu.scf import df as jdf
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu.utils import datastruct as jds
from dqc_tpu_torch.basis import autoaux as tautoaux
from dqc_tpu_torch.basis import loader as tloader
from dqc_tpu_torch.ops import eri as teri
from dqc_tpu_torch.ops.shellstruct import pack_basis as tpack
from dqc_tpu_torch.scf import df as tdf
from dqc_tpu_torch.scf import qccalc as tqc
from dqc_tpu_torch.utils import datastruct as tds
from torch_anchor_report import factored_build_df_theta

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
LC_LDA = "lda_x_erf(0.5) + 1*lr_hf(0.5) + lda_c_pw"   # tests/test_rsh.py
TIGHT = 1e-11


def _rel(t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    return np.abs(t - j).max() / np.abs(j).max()


def _benzene(basis):
    r_cc, r_ch = 2.6267, 4.6846
    atoms = []
    for i in range(6):
        a = np.pi / 3 * i
        atoms.append(f"C {r_cc*np.cos(a):.10f} {r_cc*np.sin(a):.10f} 0.0")
        atoms.append(f"H {r_ch*np.cos(a):.10f} {r_ch*np.sin(a):.10f} 0.0")
    return "; ".join(atoms)


# --- the host-side pieces ------------------------------------------------------

def test_density_fit_info_has_the_fields_of_the_jax_package():
    import dataclasses
    names = [f.name for f in dataclasses.fields(tds.DensityFitInfo)]
    assert names == [f.name for f in dataclasses.fields(jds.DensityFitInfo)]
    assert names == ["method", "auxbases"]


AUTOAUX_CASES = [(H2O, "sto-3g"), (H2O, "3-21g"), (H2O, "def2-svp"),
                 (H2O, "cc-pvdz"), ("O -1 0 0; O 1 0 0", "6-311++G**"),
                 ("benzene", "def2-svp")]


@pytest.mark.parametrize("desc,basis", AUTOAUX_CASES,
                         ids=[f"{d[:3]}-{b}" for d, b in AUTOAUX_CASES])
def test_autoaux_is_the_jax_packages(desc, basis):
    desc = _benzene(basis) if desc == "benzene" else desc
    jm = dqc_tpu.Mol(desc, basis=basis)
    tm = dqt.Mol(desc, basis=basis, device="cpu")
    ja = jautoaux.autoaux(jm.atombases)
    ta = tautoaux.autoaux(tm.atombases)
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        assert a.atomz == b.atomz
        np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
        assert [s.angmom for s in a.bases] == [s.angmom for s in b.bases]
        for sa, sb in zip(a.bases, b.bases):
            np.testing.assert_array_equal(sa.alphas, sb.alphas)
            np.testing.assert_array_equal(sa.coeffs, sb.coeffs)
    # Mol.densityfit() takes the same shells
    assert tm.densityfit() is tm and tm.dfinfo.method == "coulomb"
    assert [len(a.bases) for a in tm.dfinfo.auxbases] == \
        [len(a.bases) for a in ja]


# a made-up fitting basis for H and O in Gaussian94 form
FIT_G94 = """****
H     0
S   1   1.00
      3.0000000              1.0000000
S   1   1.00
      0.5000000              1.0000000
P   1   1.00
      1.2000000              1.0000000
****
O     0
S   2   1.00
     40.0000000              0.6000000
     12.0000000              0.4000000
S   1   1.00
      2.5000000              1.0000000
S   1   1.00
      0.6000000              1.0000000
P   1   1.00
      1.8000000              1.0000000
D   1   1.00
      1.4000000              1.0000000
****
"""


@pytest.fixture
def fit_dir(tmp_path, monkeypatch):
    """A registered directory holding test-fit.gbs in both packages; the
    lookup lists are restored afterwards."""
    monkeypatch.setattr(jloader, "_basis_dirs", [])
    monkeypatch.setattr(tloader, "_basis_dirs", [])
    (tmp_path / "test-fit.gbs").write_text(FIT_G94)
    (tmp_path / "notes.md").write_text("not a basis file\n")
    jloader.register_basis_dir(str(tmp_path))
    tloader.register_basis_dir(str(tmp_path))
    return tmp_path


def test_register_basis_dir_and_lookup(fit_dir, monkeypatch, tmp_path_factory):
    assert tloader._basis_dirs == [str(fit_dir)]
    assert tloader._dir_lookup("TEST_FIT") == str(fit_dir / "test-fit.gbs")
    assert tloader._dir_lookup("notes") is None
    for z in (1, 8):
        for norm in (False, True):
            jb = jloader.loadbasis(f"{z}:test-fit", normalize=norm)
            tb = tloader.loadbasis(f"{z}:test-fit", normalize=norm)
            assert [b.angmom for b in jb] == [b.angmom for b in tb]
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(a.alphas, b.alphas)
                np.testing.assert_array_equal(a.coeffs, b.coeffs)
    with pytest.raises(ValueError, match="no data for element"):
        tloader.loadbasis("6:test-fit")
    with pytest.raises(ValueError, match="not a directory"):
        tloader.register_basis_dir(str(fit_dir / "notes.md"))
    # a file in a registered directory overrides the vendored set
    other = tmp_path_factory.mktemp("override")
    (other / "sto-3g.g94").write_text(FIT_G94)
    tloader.register_basis_dir(str(other))
    assert tloader._basis_dirs[0] == str(other)
    assert [b.angmom for b in tloader.loadbasis("H:sto-3g")] == [0, 0, 1]
    # named fitting sets that are not vendored raise, naming the way out
    with pytest.raises(ValueError, match="register_basis_dir"):
        tloader.loadbasis("H:def2-svp-jkfit")
    # DQC_TPU_BASIS_PATH seeds the list
    monkeypatch.setattr(tloader, "_basis_dirs", [])
    monkeypatch.setenv("DQC_TPU_BASIS_PATH",
                       f"{fit_dir}:{other}:/no/such/dir")
    tloader._seed_env_dirs()
    assert tloader._basis_dirs == [str(fit_dir), str(other)]


@functools.lru_cache(maxsize=None)
def _jax_named_fit():
    mol = dqc_tpu.Mol(H2O, basis="sto-3g").densityfit(auxbasis="test-fit")
    meta_aux, params_aux = jpack(mol.dfinfo.auxbases)
    j2c = np.asarray(jeri.coul2c(meta_aux, params_aux))
    qc = dqc_tpu.HF(mol, opts=JOptions(mixed=False, tol=TIGHT)).run()
    return j2c, float(qc.energy())


def test_named_aux_basis_matches_jax(fit_dir):
    """densityfit(auxbasis=<a name found in a registered directory>): the
    metric to 1e-12 and the HF energy to 1e-9 Ha of the JAX package's."""
    j2c, e_jax = _jax_named_fit()
    mol = dqt.Mol(H2O, basis="sto-3g", device="cpu").densityfit(
        auxbasis="test-fit")
    assert [len(a.bases) for a in mol.dfinfo.auxbases] == [5, 3, 3]
    meta_aux, params_aux = tpack(mol.dfinfo.auxbases)
    assert _rel(teri.coul2c(meta_aux, params_aux), j2c) <= 1e-12
    qc = dqt.HF(mol, opts=dqt.SCFOptions(tol=TIGHT)).run()
    assert abs(float(qc.energy()) - e_jax) <= 1e-9


# --- integrals -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ints(basis, omega):
    """The JAX package's coul2c and coul3c of H2O/basis autoaux (jitted: the
    compile is a third of the eager dispatch's)."""
    mol = dqc_tpu.Mol(H2O, basis=basis).densityfit()
    meta_aux, params_aux = jpack(mol.dfinfo.auxbases)
    j2c = jax.jit(lambda pa: jeri.coul2c(meta_aux, pa, omega=omega))
    j3c = jax.jit(lambda p, pa: jeri.coul3c(mol.meta, p, meta_aux, pa,
                                            omega=omega))
    return (np.asarray(j2c(params_aux)),
            np.asarray(j3c(mol.params, params_aux)))


@pytest.mark.parametrize("basis", ["sto-3g", "3-21g"])
@pytest.mark.parametrize("omega", [None, 0.33])
def test_coul2c_coul3c_match_jax(basis, omega):
    j2c, j3c = _jax_ints(basis, omega)
    mol = dqt.Mol(H2O, basis=basis, device="cpu").densityfit()
    meta_aux, params_aux = tpack(mol.dfinfo.auxbases)
    t2c = teri.coul2c(meta_aux, params_aux, omega=omega)
    t3c = teri.coul3c(mol.meta, mol.params, meta_aux, params_aux,
                      omega=omega)
    assert _rel(t2c, j2c) <= 1e-12
    assert _rel(t3c, j3c) <= 1e-12
    assert torch.equal(t3c, t3c.transpose(0, 1))


def test_hermite_factor_single_matches_jax():
    from dqc_tpu.ops.eri import hermite_factor_single as jh
    rng = np.random.default_rng(4)
    pos = rng.standard_normal((3, 3))
    al = rng.uniform(0.2, 5.0, (3, 2))
    co = rng.standard_normal((3, 2))
    for l in range(5):
        j = jh(l, jax.numpy.asarray(pos), jax.numpy.asarray(al),
               jax.numpy.asarray(co))
        t = teri.hermite_factor_single(l, torch.tensor(pos), torch.tensor(al),
                                       torch.tensor(co))
        assert t.L == j.L == l
        assert _rel(t.H, j.H) <= 1e-13
        np.testing.assert_array_equal(t.P.numpy(), np.asarray(j.P))


# --- the fit ---------------------------------------------------------------------

def _seeded_dms(n):
    rng = np.random.default_rng(11)
    dm = rng.standard_normal((n, n))
    dm2 = rng.standard_normal((2, n, n))
    return dm + dm.T, dm2 + dm2.transpose(0, 2, 1)


@pytest.mark.parametrize("spin", ["restricted", "polarized"])
def test_df_j_df_k_match_jax(spin):
    """The contractions alone: the JAX package's df_j/df_k on its j3c of
    H2O/STO-3G and a seeded well-conditioned v_inv = W W^T, the port's on
    B_Q = sum_P W[P,Q] j3c[:,:,P], at seeded symmetric dms: 1e-12."""
    _, j3c = _jax_ints("sto-3g", None)
    n, naux = j3c.shape[1], j3c.shape[2]
    rng = np.random.default_rng(5)
    w = rng.standard_normal((naux, naux)) / np.sqrt(naux) + np.eye(naux)
    jfit = {"j3c": jax.numpy.asarray(j3c), "v_inv": jax.numpy.asarray(w @ w.T)}
    tfit = {"B": torch.tensor(np.einsum("ikp,pq->iqk", j3c, w).copy())}
    dm, dm2 = _seeded_dms(n)
    if spin == "restricted":
        assert _rel(tdf.df_j(tfit, torch.tensor(dm)), jdf.df_j(jfit, dm)) \
            <= 1e-12
        assert _rel(tdf.df_k(tfit, torch.tensor(dm)), jdf.df_k(jfit, dm)) \
            <= 1e-12
    else:
        k2 = tdf.df_k(tfit, torch.tensor(dm2))
        assert k2.shape == (2, n, n)
        assert _rel(k2, jdf.df_k(jfit, dm2)) <= 1e-12
        assert torch.equal(k2[1], tdf.df_k(tfit, torch.tensor(dm2[1])))


@functools.lru_cache(maxsize=None)
def _port_hf_dm():
    """The converged DF HF density of H2O/STO-3G: the physical dm the fit
    tests contract with."""
    mol = dqt.Mol(H2O, basis="sto-3g", device="cpu").densityfit()
    return dqt.HF(mol, opts=dqt.SCFOptions(tol=TIGHT)).run()._dm.numpy()


@pytest.mark.parametrize("omega", [None, 0.5])
def test_build_df_theta_fits_as_the_jax_package(omega):
    """sum_Q B_Q x B_Q = j3c j2c^+ j3c, the JAX package's pseudo-inverse
    (eigenvalues above 1e-12 of the largest). The reference values are the
    JAX package's j2c and j3c in numpy, contracted in factored form with
    V diag(w^-1/2) on the kept spectrum. The port's J and K at the
    converged DF HF dm equal them to 1e-11 relative: Coulomb metric (ratio
    3.2e-9, every function kept, Cholesky) and attenuated metric (omega =
    0.5: singular to rounding, 52 of 86 functions kept).
    The JAX package's own df_j/df_k contract j3c with the explicit v_inv,
    which loses about eps * cond to cancellation: at this dm it is 4.5e-10
    (J) off with the Coulomb metric and 1.5e-6 (K) with the attenuated one
    (ROADMAP queue C); held here to 1e-8 and 1e-5, measured bounds of
    that fault."""
    j2c, j3c = _jax_ints("sto-3g", omega)
    mol = dqt.Mol(H2O, basis="sto-3g", device="cpu").densityfit()
    meta_aux, params_aux = tpack(mol.dfinfo.auxbases)
    df, info = tdf.build_df_theta(mol.meta, mol.params, meta_aux, params_aux,
                                  omega=omega)
    naux = meta_aux.nao
    assert df["B"].shape == (mol.meta.nao, naux, mol.meta.nao)
    assert info["naux"] == naux
    w, v = np.linalg.eigh(j2c)
    assert info["metric_ratio"] == pytest.approx(w[0] / w[-1], rel=1e-3)
    keep = w > tdf.METRIC_CUTOFF * w[-1]
    if omega is None:
        assert keep.all() and info["naux_kept"] == naux
    else:
        assert info["naux_kept"] == keep.sum() == 52
    bref = np.einsum("ijp,pq->ijq", j3c, v[:, keep] / np.sqrt(w[keep]))
    dm = _port_hf_dm()
    j_ref = np.einsum("ijq,q->ij", bref, np.einsum("klq,kl->q", bref, dm))
    k_ref = np.einsum("ikq,kl,jlq->ij", bref, dm, bref)
    j, k = tdf.df_j(df, torch.tensor(dm)), tdf.df_k(df, torch.tensor(dm))
    assert _rel(j, j_ref) <= 1e-11
    assert _rel(k, k_ref) <= 1e-11
    meta, params, meta_aux, params_aux = jax_mol_and_aux()
    jfit = jax.jit(lambda p, pa: jdf.build_df_theta(
        meta, p, meta_aux, pa, omega=omega))(params, params_aux)
    gap = 1e-8 if omega is None else 1e-5
    assert _rel(jdf.df_j(jfit, dm), j_ref) <= gap
    assert _rel(jdf.df_k(jfit, dm), k_ref) <= gap


def jax_mol_and_aux():
    mol = dqc_tpu.Mol(H2O, basis="sto-3g").densityfit()
    return (mol.meta, mol.params) + tuple(jpack(mol.dfinfo.auxbases))


def test_pinv_sqrt_derivatives():
    """The Daleckii-Krein rule of the attenuated fit's j2c^(+1/2): gradcheck
    and gradgradcheck on a seeded SPD matrix, one eigenvalue under the
    cutoff (a cutoff of 0.05 here, so that the finite differences do not
    move it across); finite derivatives at an exactly degenerate
    spectrum."""
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    w = np.array([0.01, 0.3, 0.7, 1.1, 2.0, 3.5])
    a = torch.tensor((q * w) @ q.T, requires_grad=True)
    fn = lambda x: tdf.pinv_sqrt(0.5 * (x + x.T), cutoff=0.05)[0]
    p, wt = tdf.pinv_sqrt(a.detach(), cutoff=0.05)
    assert int((wt > 0.05 * 3.5).sum()) == 5
    want = (q[:, 1:] / np.sqrt(w[1:])) @ q[:, 1:].T
    assert np.abs(p.numpy() - want).max() <= 1e-13
    assert torch.autograd.gradcheck(fn, (a,), eps=1e-7, atol=1e-6)
    assert torch.autograd.gradgradcheck(fn, (a,), eps=1e-7, atol=1e-5)
    b = torch.tensor((q * np.array([1.0, 1.0, 1.0, 2.0, 2.0, 4.0])) @ q.T,
                     requires_grad=True)
    (g,) = torch.autograd.grad(fn(b).sum(), b)
    assert torch.isfinite(g).all()


def test_ill_conditioned_metric_raises():
    """Two aux s functions 1e-7 apart in exponent on one atom: the metric's
    eigenvalue ratio is far below 1e-12, where the JAX package would drop a
    function. The port raises, naming the ratio and ROADMAP queue C."""
    from dqc_tpu_torch.utils.datastruct import AtomCGTOBasis, CGTOBasis
    mol = dqt.Mol("H 0 0 0; H 1.4 0 0", basis="sto-3g", device="cpu")
    s = lambda a: CGTOBasis(angmom=0, alphas=np.array([a]),
                            coeffs=np.array([1.0]))
    aux = [AtomCGTOBasis(atomz=1, bases=[s(1.0), s(1.0 + 1e-7)],
                         pos=mol.atombases[0].pos),
           AtomCGTOBasis(atomz=1, bases=[s(1.0)], pos=mol.atombases[1].pos)]
    meta_aux, params_aux = tpack(aux)
    with pytest.raises(NotImplementedError, match=r"ratio .*queue C"):
        tdf.build_df_theta(mol.meta, mol.params, meta_aux, params_aux)
    mol._dfinfo = tds.DensityFitInfo("coulomb", aux)
    with pytest.raises(NotImplementedError, match="queue C"):
        dqt.HF(mol).run()


# --- the route -------------------------------------------------------------------

def test_densityfit_route_theta_and_stats(monkeypatch):
    """A DF molecule builds no eri_k and passes the dense size limit; a pure
    functional computes no RI-K. Past the dense limit the molecule without
    densityfit() takes the blocked route."""
    mol = dqt.Mol(H2O, basis="sto-3g", grid=1, device="cpu")
    with pytest.raises(NotImplementedError, match="only 'coulomb'"):
        mol.densityfit(method="exchange")
    assert mol.dfinfo is None
    monkeypatch.setattr(tqc.config, "DENSE_ERI_BYTES_LIMIT", 100)
    assert dqt.KS(mol, xc="pbe").jk_mode == "blocked"
    mol.densityfit()
    assert dqt.KS(mol, xc="pbe").jk_mode == "df"
    qc = dqt.KS(mol, xc="camb3lyp")
    stats = {}
    th = qc._build_theta(qc._all_params(), stats=stats)
    assert "eri_k" not in th and "eri_lr_k0" not in th
    assert set(th["df"]) == {"B"} and set(th["df_lr0"]) == {"B"}
    assert "eri_s" not in stats and "eri_lr_s" not in stats
    for k in ("int1e_s", "df_s", "coul2c_s", "coul3c_s", "factor_s",
              "df_lr_s", "grid_s"):
        assert stats[k] >= 0.0, k
    assert stats["naux"] == th["df"]["B"].shape[1]
    assert 1e-12 < stats["metric_ratio"] < 1.0
    assert [r["omega"] for r in stats["df_lr"]] == [0.33]
    eng = dqt.KS(mol, xc="pbe").engine
    d = torch.eye(mol.meta.nao, dtype=torch.float64)
    j, k = eng.jk_parts(d, th)
    assert k is None and torch.allclose(j, tdf.df_j(th["df"], d))
    j, k = qc.engine.jk_parts(d, th)
    assert torch.equal(k, tdf.df_k(th["df"], d))
    assert torch.equal(qc.engine._k_lr(th, d, 0), tdf.df_k(th["df_lr0"], d))
    assert dqt.HF(mol).engine.jk_parts(d, th)[1] is not None


# --- SCF energies and derivatives ------------------------------------------------

SCF_CASES = {
    "hf": dict(xc=None, spin=None),
    "rks-pbe": dict(xc="gga_x_pbe + gga_c_pbe", spin=None),
    "uks-lda": dict(xc="lda_x + lda_c_pw", spin=2),
    "lc-lda": dict(xc=LC_LDA, spin=None),
}


@functools.lru_cache(maxsize=None)
def _jax_energy(case):
    """The JAX package's converged DF energy with its fit contracted in
    factored form (torch_anchor_report.factored_build_df_theta; the SCF,
    integrals, grid and XC its own)."""
    c = SCF_CASES[case]
    mol = dqc_tpu.Mol(H2O, basis="sto-3g", grid=1, spin=c["spin"]).densityfit()
    opts = JOptions(mixed=False, tol=TIGHT)
    own = jdf.build_df_theta
    jdf.build_df_theta = factored_build_df_theta
    try:
        qc = (dqc_tpu.HF(mol, opts=opts) if c["xc"] is None
              else dqc_tpu.KS(mol, xc=c["xc"], opts=opts))
        return float(qc.run().energy())
    finally:
        jdf.build_df_theta = own


@pytest.mark.parametrize("case", sorted(SCF_CASES))
def test_df_scf_energy_matches_jax(case):
    c = SCF_CASES[case]
    mol = dqt.Mol(H2O, basis="sto-3g", grid=1, spin=c["spin"],
                  device="cpu").densityfit()
    opts = dqt.SCFOptions(tol=TIGHT)
    qc = (dqt.HF(mol, opts=opts) if c["xc"] is None
          else dqt.KS(mol, xc=c["xc"], opts=opts)).run()
    assert qc.stats["residual"] <= TIGHT
    assert "df" in qc._theta and "eri_k" not in qc._theta
    assert abs(float(qc.energy()) - _jax_energy(case)) <= 1e-9


@functools.lru_cache(maxsize=None)
def _jax_polarized_df_grad():
    mol = dqc_tpu.Mol(H2O, basis="sto-3g", grid=1).densityfit()
    qc = dqc_tpu.KS(mol, xc="gga_x_pbe + gga_c_pbe", restricted=False,
                    opts=JOptions(mixed=False, tol=1e-12))
    qc.run()
    p = qc._all_params(with_fields=False)

    def e_of_pos(pos):
        q = dict(p)
        q["basis"] = dict(p["basis"], atompos=pos)
        return qc.energy_fn(q)
    # jitted, in the positions alone: a third of the eager jax.grad's time
    return np.asarray(jax.jit(jax.grad(e_of_pos))(p["basis"]["atompos"]))


def test_df_gradient_matches_jax_grad():
    """Unrestricted DF PBE on closed-shell H2O (tests/test_adjoint.py::
    test_adjoint_polarized_df): dE/datompos against jax.grad of the JAX
    package's energy_fn, 1e-9."""
    g_jax = _jax_polarized_df_grad()
    mol = dqt.Mol(H2O, basis="sto-3g", grid=1, device="cpu").densityfit()
    qc = dqt.KS(mol, xc="gga_x_pbe + gga_c_pbe", restricted=False,
                opts=dqt.SCFOptions(tol=1e-12))
    g = qc.energy_grad()["basis"]["atompos"].numpy()
    assert np.abs(g - g_jax).max() <= 1e-9
    assert np.abs(g.sum(0)).max() <= 1e-9


def test_df_energy_hvp_matches_central_differences():
    """energy_hvp along a seeded position direction against central
    differences of energy_grad (h = 1e-4 Bohr), HF/STO-3G DF on H2O off
    its mirror plane: 1e-6 (the differences' own truncation)."""
    desc = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0.1 -1.4309 -0.8867"
    mol = dqt.Mol(desc, basis="sto-3g", device="cpu").densityfit()
    qc = dqt.HF(mol, opts=dqt.SCFOptions(tol=1e-12)).run()
    p0 = qc._all_params()
    pos0 = p0["basis"]["atompos"]
    d = torch.tensor(np.random.default_rng(6).standard_normal(pos0.shape))
    v = qc._like(p0, [None] * 64)
    v["basis"] = dict(v["basis"], atompos=d)
    hv = qc.energy_hvp(v)["basis"]["atompos"]
    h = 1e-4
    gs = []
    for sgn in (1, -1):
        p = dict(p0, basis=dict(p0["basis"], atompos=pos0 + sgn * h * d))
        gs.append(qc.energy_grad(p)["basis"]["atompos"])
    fd = (gs[0] - gs[1]) / (2 * h)
    assert (hv - fd).abs().max().item() <= 1e-6


def test_df_forces_keep_the_mirror_symmetry_of_benzene():
    """Benzene HF/STO-3G on the DF route: the forces map onto themselves
    under x -> -x and y -> -y to 1e-10 Ha/Bohr and sum to zero (the
    Cholesky fit's derivative has no 1/split term at the metric's
    degenerate eigenvalues)."""
    mol = dqt.Mol(_benzene("sto-3g"), basis="sto-3g",
                  device="cpu").densityfit()
    qc = dqt.HF(mol, opts=dqt.SCFOptions(tol=1e-11))
    F = -qc.energy_grad()["basis"]["atompos"].numpy()

    def mirror(F, axis):
        G = np.zeros_like(F)
        for k in range(6):
            j = (3 - k) % 6 if axis == 0 else (-k) % 6
            G[2 * j:2 * j + 2] = F[2 * k:2 * k + 2]
            G[2 * j:2 * j + 2, axis] *= -1
        return G
    for axis in (0, 1):
        assert np.abs(F - mirror(F, axis)).max() <= 1e-10
    assert np.abs(F.sum(0)).max() <= 1e-9
    assert np.abs(F).max() > 1e-4
