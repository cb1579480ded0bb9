"""PyTorch/CUDA port: the SAD start (superposition of atomic densities)
against the JAX package, on the CPU.

_sad_occ for every element of its aufbau table; sad_dm0 of H2O/def2-SVP
(one fractionally occupied atomic KS-LDA per element, assembled
block-diagonally) within 1e-6 max-abs of the JAX package's; the atoms'
occupation weights through Mol(orb_weights=...); and the start rules of
SCF_QCCalc: SAD at and above GUESS_NAO (lowered here so that a small
molecule reaches it), memoized per calc, GWH on a failure (remembered) or
for guess="gwh", the core guess below GUESS_NAO; every start converges to
the same energy.
"""
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.scf import qccalc as jqc
from dqc_tpu_torch.scf import qccalc as tqc

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"


@pytest.mark.parametrize("z", range(1, 55))
def test_sad_occ_matches_jax(z):
    """Over 30 orbitals every element fits; over 9 (1s to 3p) those past
    argon do not, and both packages refuse them."""
    for nao in (30, 9):
        if nao == 9 and z > 18:
            for f in (jqc._sad_occ, tqc._sad_occ):
                with pytest.raises(ValueError, match="too short"):
                    f(z, nao)
            continue
        j = np.asarray(jqc._sad_occ(z, nao))
        t = tqc._sad_occ(z, nao)
        assert len(t) == nao and np.array_equal(np.asarray(t), j)
    assert abs(sum(tqc._sad_occ(z, 30)) - z) <= 1e-12


def test_sad_occ_refuses_elements_past_its_table():
    for f in (jqc._sad_occ, tqc._sad_occ):
        with pytest.raises(ValueError, match="too short"):
            f(55, 40)


def test_atom_orb_weights_match_jax():
    """The occupation of a SAD atom (spin 0, one weight per AO) reaches
    the SCF unchanged in both packages."""
    w = tqc._sad_occ(8, 14)
    desc = (np.array([8.0]), np.zeros((1, 3)))
    j = dqc_tpu.Mol(desc, basis="def2-svp", spin=0,
                    orb_weights=jqc._sad_occ(8, 14)).get_orb_weights()
    t = dqt.Mol(desc, basis="def2-svp", spin=0, orb_weights=w,
                device="cpu")
    assert t.meta.nao == 14 and not t.polarized
    assert np.array_equal(t.get_orb_weights().numpy(), np.asarray(j))


def test_sad_dm0_matches_jax():
    j = np.asarray(jqc.sad_dm0(dqc_tpu.Mol(H2O, basis="def2-svp")))
    t = tqc.sad_dm0(dqt.Mol(H2O, basis="def2-svp", device="cpu"))
    assert t.shape == (24, 24) and t.dtype == torch.float64
    assert np.abs(t.numpy() - j).max() <= 1e-6
    # block-diagonal by atom (O's 14 AOs first)
    assert float(t[:14, 14:].abs().max()) == 0.0


def _h2o_ks(**opts):
    mol = dqt.Mol(H2O, basis="sto-3g", grid=1, device="cpu")
    return dqt.KS(mol, xc="b3lyp", opts=dqt.SCFOptions(**opts))


@pytest.fixture
def small_guess_nao(monkeypatch):
    """Let H2O/STO-3G (nao 7) take the start of a large molecule."""
    monkeypatch.setattr(tqc, "GUESS_NAO", 5)


def test_scf_from_sad_converges_to_the_core_guess_energy(small_guess_nao,
                                                         monkeypatch):
    e_sad = float(_h2o_ks().run().energy())      # nao 7 >= 5: SAD now
    calls = []
    real = tqc.sad_dm0

    def counted(mol):
        calls.append(mol)
        return real(mol)
    monkeypatch.setattr(tqc, "sad_dm0", counted)
    qc = _h2o_ks().run()
    assert qc.stats["guess"] == "sad"
    assert qc.stats["sad_elements"] == [1, 8] and qc.stats["sad_s"] > 0
    assert abs(float(qc.energy()) - e_sad) <= 1e-9
    qc.run()                                      # memoized per calc
    assert len(calls) == 1
    monkeypatch.setattr(tqc, "GUESS_NAO", 96)
    qc_core = _h2o_ks().run()
    assert qc_core.stats["guess"] == "core"
    assert abs(float(qc_core.energy()) - e_sad) <= 1e-9


def test_sad_failure_takes_gwh_once(small_guess_nao, monkeypatch):
    calls = []

    def broken(mol):
        calls.append(mol)
        raise ValueError("no atomic density")
    monkeypatch.setattr(tqc, "sad_dm0", broken)
    qc = _h2o_ks().run()
    assert qc.stats["guess"] == "gwh" and qc._sad_failed
    qc.run()
    assert len(calls) == 1
    e_gwh = float(_h2o_ks(guess="gwh").run().energy())
    assert abs(float(qc.energy()) - e_gwh) <= 1e-9


def test_other_sad_errors_propagate(small_guess_nao, monkeypatch):
    """Only the failures of the data (ValueError) take GWH: an error of the
    atomic SCFs' machinery, such as a kernel that fails to launch, is not
    hidden behind another start."""
    def broken(mol):
        raise RuntimeError("ds_jk kernel launch failed")
    monkeypatch.setattr(tqc, "sad_dm0", broken)
    qc = _h2o_ks()
    with pytest.raises(RuntimeError, match="launch failed"):
        qc.run()
    assert not getattr(qc, "_sad_failed", False)


def test_non_finite_sad_density_takes_gwh(small_guess_nao, monkeypatch):
    nan = torch.full((7, 7), float("nan"), dtype=torch.float64)
    monkeypatch.setattr(tqc, "sad_dm0", lambda mol: nan)
    qc = _h2o_ks().run()
    assert qc.stats["guess"] == "gwh"
    assert qc.stats["residual"] <= qc.opts.tol


def test_polarized_scf_from_sad(small_guess_nao):
    """A polarized calc starts from half the SAD density per spin."""
    mol = dqt.Mol(H2O, basis="sto-3g", grid=1, spin=2, device="cpu")
    qc = dqt.KS(mol, xc="pbe").run()
    assert qc.stats["guess"] == "sad"
    e_gwh = float(dqt.KS(mol, xc="pbe", opts=dqt.SCFOptions(guess="gwh"))
                  .run().energy())
    assert abs(float(qc.energy()) - e_gwh) <= 1e-9
