"""PyTorch/CUDA port: the variational SCF, the external potential vext,
dm2dens, Mol.make_copy and ValGrad against the JAX package, on the CPU.

The JAX package's variational energies take a BFGS compile each, so they
are stored below, made by

    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py props_small

(part of the "properties" case; SCFOptions(mixed=False, tol=1e-11)). The
rest compares live. Tolerances are written beside each check.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu.utils.datastruct import ValGrad as JValGrad
from dqc_tpu.xc import integrate as jintegrate
from dqc_tpu_torch.xc import integrate as tintegrate

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2 = "H 0 0 0; H 1.0 0 0"
# dqc_tpu HF/3-21G energies (torch_anchor_report.py props_small): the DIIS
# solver and the variational one with each orbital parametrisation
JAX_H2_DIIS = -1.0719534570077522
JAX_H2_VARIATIONAL = {"matexp": -1.0719534570077514,
                      "qr": -1.0719534570077527,
                      "ov": -1.0719534570077518}
JAX_H_ATOM_SPIN1 = {"diis": -0.4961986093809391, "ov": -0.4961986093809391}


def _mol(desc, basis="3-21G", **kw):
    return dqt.Mol(desc, basis=basis, device="cpu", **kw)


@pytest.mark.parametrize("orb_param", ["matexp", "qr", "ov"])
def test_variational_matches_jax_and_diis(orb_param):
    """HF H2/3-21G by BFGS over orbital rotations: against the JAX
    package's variational energy of the same parametrisation and the
    port's DIIS energy, both to 1e-10 Ha (BFGS stops at max |gradient|
    1e-9, an energy error of order 1e-18); the result's DIIS residual."""
    mol = _mol(H2)
    e_diis = dqt.HF(mol).run().energy().item()
    assert abs(e_diis - JAX_H2_DIIS) <= 1e-10
    qc = dqt.HF(mol, opts=dqt.SCFOptions(method="variational",
                                         orb_param=orb_param)).run()
    e = qc.energy().item()
    assert abs(e - JAX_H2_VARIATIONAL[orb_param]) <= 1e-10
    assert abs(e - e_diis) <= 1e-10
    assert qc.stats["var_grad_max_abs"] <= 1e-9
    assert qc.stats["residual"] <= 1e-8


def test_variational_ov_polarized_h_atom():
    """The H atom with spin 1 (one occupied orbital in one channel, none
    in the other) by the occupied x virtual parametrisation, against the
    JAX package's to 1e-10 Ha; variational=True selects the solver."""
    mol = _mol("H 0 0 0", spin=1)
    qc = dqt.HF(mol, variational=True,
                opts=dqt.SCFOptions(orb_param="ov")).run()
    assert qc.opts.method == "variational"
    assert abs(qc.energy().item() - JAX_H_ATOM_SPIN1["ov"]) <= 1e-10
    assert abs(dqt.HF(mol).run().energy().item()
               - JAX_H_ATOM_SPIN1["diis"]) <= 1e-10


def test_variational_ks_and_its_gradient():
    """KS-LDA H2/3-21G (grid 1) by the variational solver against DIIS to
    1e-10 Ha, and the implicit-derivative forces of the variational
    calc against the DIIS calc's to 1e-8 Ha/Bohr (both converge to
    residuals below 1e-8)."""
    mol = _mol(H2, grid=1)
    ks = dqt.KS(mol, xc="lda_x").run()
    kv = dqt.KS(mol, xc="lda_x", variational=True).run()
    assert abs(kv.energy().item() - ks.energy().item()) <= 1e-10
    hf = dqt.HF(mol).run()
    hv = dqt.HF(mol, variational=True).run()
    fd = hf.energy_grad()["basis"]["atompos"]
    fv = hv.energy_grad()["basis"]["atompos"]
    assert float((fd - fv).abs().max()) <= 1e-8
    assert float(fd.abs().max()) > 1e-2
    with pytest.raises(ValueError, match="orb_param"):
        dqt.HF(mol, opts=dqt.SCFOptions(method="variational",
                                        orb_param="cayley")).run()


VEXT_DESC = "H -0.7 0 0; H 0.7 0 0"


def test_vext_matrix_and_energy_match_jax():
    """V_ext of a seeded potential on H2/STO-3G's level-1 grid against the
    JAX package's vext_matrix to 1e-13, and the HF energy with it against
    dqc_tpu.HF's to 1e-10 Ha."""
    jm = dqc_tpu.Mol(VEXT_DESC, basis="sto-3g", grid=1)
    ng = jm.setup_grid().w0.shape[0]
    v = 0.01 * np.random.default_rng(0).standard_normal(ng)
    tm = _mol(VEXT_DESC, basis="sto-3g", grid=1, vext=v)
    assert tm.setup_grid().w0.shape[0] == ng
    vt = tintegrate.vext_matrix(tm.meta, tm.params, tm.setup_grid(), v)
    vj = np.asarray(jintegrate.vext_matrix(jm.meta, jm.params,
                                           jm.setup_grid(), jnp.asarray(v)))
    assert np.abs(vt.numpy() - vj).max() <= 1e-13
    jmv = dqc_tpu.Mol(VEXT_DESC, basis="sto-3g", grid=1, vext=v)
    ej = float(dqc_tpu.HF(jmv, opts=JOptions(mixed=False)).run().energy())
    assert abs(dqt.HF(tm).run().energy().item() - ej) <= 1e-10


def test_vext_zero_shift_and_gradient():
    """As tests/test_grads.py:158-198 does for the JAX package: vext = 0
    leaves the energy unchanged (1e-12 Ha); a constant c adds c N up to
    the level-1 grid's quadrature of the overlap (5e-4 Ha); dE/dvext of
    KS-LDA from energy_grad against central differences (h = 1e-5) to
    1e-7 at three points."""
    m0 = _mol(VEXT_DESC, basis="sto-3g", grid=1)
    e_plain = dqt.HF(m0).run().energy().item()
    ng = m0.setup_grid().w0.shape[0]
    ez = dqt.HF(m0.make_copy(vext=np.zeros(ng))).run().energy().item()
    assert abs(ez - e_plain) <= 1e-12
    c = 0.037
    ec = dqt.HF(m0.make_copy(vext=np.full(ng, c))).run().energy().item()
    assert abs(ec - e_plain - 2.0 * c) <= 5e-4
    v0 = 0.01 * np.random.default_rng(0).standard_normal(ng)
    qc = dqt.KS(m0.make_copy(vext=v0), xc="lda_x")
    g = qc.energy_grad()["vext"]
    p0 = qc._all_params()
    h = 1e-5
    for i in (0, ng // 2, ng - 1):
        dv = torch.zeros(ng, dtype=torch.float64)
        dv[i] = h
        es = [qc.energy_fn(dict(p0, vext=p0["vext"] + s * dv)).item()
              for s in (1, -1)]
        assert abs((es[0] - es[1]) / (2 * h) - g[i].item()) <= 1e-7


def test_dm2dens_matches_jax_and_integrates_to_n():
    """dm2dens of HF H2/3-21G at its level-3 grid points against the JAX
    package's on the same dm to 1e-13, and its integral over the grid
    equal to 2 to 1e-6 (tests/test_scf.py:286); a polarized dm gives a
    SpinParam of the two densities."""
    desc = "H -0.5 0 0; H 0.5 0 0"
    qc = dqt.HF(_mol(desc, grid=3)).run()
    mol = qc.mol
    gt = tintegrate.setup_grid_theta(mol.meta, mol.params, mol.setup_grid())
    rho = qc.dm2dens(gt["coords"])
    assert abs(float((rho * gt["dvol"]).sum()) - 2.0) <= 1e-6
    jq = dqc_tpu.HF(dqc_tpu.Mol(desc, basis="3-21G", grid=3))
    coords = gt["coords"][::97].numpy()
    dm = qc.aodm().numpy()
    rj = np.asarray(jq.dm2dens(jnp.asarray(coords), jnp.asarray(dm)))
    assert np.abs(qc.dm2dens(coords).numpy() - rj).max() <= 1e-13
    sp = qc.dm2dens(coords, dqt.SpinParam(u=0.5 * qc.aodm(),
                                          d=0.5 * qc.aodm()))
    assert isinstance(sp, dqt.SpinParam)
    assert np.abs((sp.u + sp.d).numpy() - rj).max() <= 1e-13


def test_make_copy_matches_jax():
    """make_copy with new positions (tests/test_system.py:36) against the
    JAX package's: the same positions and basis; the device, fields and
    occupations carry over."""
    desc = "H -0.5 0 0; H 0.5 0 0"
    new = np.array([[-0.7, 0.0, 0.0], [0.7, 0.0, 0.0]])
    tm = _mol(desc, basis="sto-3g", efield=np.array([0.0, 0.0, 0.01]))
    t2 = tm.make_copy(atompos=torch.as_tensor(new))
    j2 = dqc_tpu.Mol(desc, basis="sto-3g").make_copy(atompos=jnp.asarray(new))
    np.testing.assert_array_equal(t2.params["atompos"].numpy(),
                                  np.asarray(j2.params["atompos"]))
    assert t2.meta.nao == tm.meta.nao == j2.meta.nao
    assert t2.device == tm.device
    assert t2.efield is tm.efield
    for a, b in zip(t2.params["alphas"], j2.params["alphas"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t3 = tm.make_copy(spin=2)
    assert t3.polarized and t3.spin == 2


def test_valgrad_add_and_mul_match_jax():
    """ValGrad's + and * against the JAX package's on the same arrays;
    adding mismatched components raises in both."""
    rng = np.random.default_rng(1)
    v, g, k = rng.standard_normal(5), rng.standard_normal((3, 5)), \
        rng.standard_normal(5)
    ta = dqt.ValGrad(torch.as_tensor(v), torch.as_tensor(g), kin=torch.as_tensor(k))
    ja = JValGrad(jnp.asarray(v), jnp.asarray(g), kin=jnp.asarray(k))
    tr = 2.5 * (ta + ta * 0.5)
    jr = 2.5 * (ja + ja * 0.5)
    for f in ("value", "grad", "kin"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), rtol=1e-15)
    assert tr.lapl is None and jr.lapl is None
    with pytest.raises(ValueError, match="mismatched"):
        ta + dqt.ValGrad(torch.as_tensor(v))
    with pytest.raises(ValueError, match="mismatched"):
        ja + JValGrad(jnp.asarray(v))
