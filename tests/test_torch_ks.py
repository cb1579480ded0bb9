"""PyTorch/CUDA port: Kohn-Sham end to end against the JAX package, on the
CPU.

Each JAX Kohn-Sham run (no f32 warm phase) happens once per process; its
theta and grid tables are carried across (convert.theta_from_numpy,
convert.grid_theta_from_numpy) so that one Fock build and one energy of the
port's KSEngine are held against the JAX KSEngine on identical inputs, to
1e-11 (float64 sums in another order on values of order 1 to 100). The
converged energies of the two packages, each on its own integrals and grid,
agree to 1e-9 Ha: both stop at a residual of 1e-8 and the energy error is
quadratic in it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.scf import engine as jengine
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu.xc import getxc as jgetxc
from dqc_tpu_torch.convert import grid_theta_from_numpy, theta_from_numpy
from dqc_tpu_torch.scf import engine as tengine
from dqc_tpu_torch.scf import qccalc as tqc
from dqc_tpu_torch.xc import getxc as tgetxc

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
CASES = {
    # the entry point's own configuration (__graft_entry__.entry)
    "b3lyp-restricted": dict(xc="b3lyp", spin=None),
    # a polarized GGA: the triplet of H2O
    "pbe-polarized": dict(xc="pbe", spin=2),
}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    c = CASES[case]
    mol = dqc_tpu.Mol(H2O, basis="3-21G", grid=1, spin=c["spin"])
    qc = dqc_tpu.KS(mol, xc=c["xc"], opts=JOptions(mixed=False)).run()
    return qc, float(qc.energy())


def _port_mol(case, **kw):
    return dqt.Mol(H2O, basis="3-21G", grid=1, spin=CASES[case]["spin"],
                   device="cpu", **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ks_energy_matches_jax(case):
    _, e_jax = _jax_run(case)
    qc = dqt.KS(_port_mol(case), xc=CASES[case]["xc"]).run()
    assert qc.stats["residual"] <= qc.opts.tol
    assert abs(float(qc.energy()) - e_jax) <= 1e-9


def _carried(case):
    """(JAX calc, JAX theta, port theta from the same numbers, dm)."""
    qc, _ = _jax_run(case)
    th = qc._theta
    theta_np = {k: np.asarray(th[k]) for k in
                ("hcore", "ovlp", "X", "keep", "enuc", "occ", "eri")}
    g = th["grid"]
    tt = theta_from_numpy(theta_np, device="cpu")
    tt["grid"] = grid_theta_from_numpy(
        np.asarray(g["coords"]), np.asarray(g["dvol"]), np.asarray(g["ao"]),
        np.asarray(g["ao_grad"]), device="cpu")
    dm = qc._dm
    return qc, th, tt, np.array(dm)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("stage", ["fock", "energy"])
def test_ks_engine_stage_matches_jax(case, stage):
    qc, jt, tt, dm = _carried(case)
    jeng = qc.engine
    teng = tengine.KSEngine(tgetxc.get_xc(CASES[case]["xc"]),
                            polarized=jeng.polarized)
    j = getattr(jeng, stage)(jnp.asarray(dm), jt)
    t = getattr(teng, stage)(torch.as_tensor(dm), tt)
    diff = np.abs(t.numpy() - np.asarray(j)).max()
    assert diff <= 1e-11, diff


def test_ks_fock_and_energy_stage_of_a_pure_functional():
    """A functional without exact exchange: K is computed with J but not
    used (the Fock matrix and energy do not depend on it)."""
    qc, jt, tt, dm = _carried("pbe-polarized")
    teng = tengine.KSEngine(tgetxc.get_xc("pbe"), polarized=True)
    d = torch.as_tensor(dm)
    j, k = teng.jk_parts(d, tt)
    f1 = teng.fock_from_parts(d, j, k, tt)
    f2 = teng.fock_from_parts(d, j, 1e3 * k, tt)
    assert torch.equal(f1, f2)
    assert torch.equal(teng.energy_from_parts(d, j, k, tt),
                       teng.energy_from_parts(d, j, 0 * k, tt))


@pytest.mark.parametrize("case", ["hf"] + sorted(CASES))
def test_energy_gradient_in_dm_matches_jax(case):
    """d E / d dm through dm2energy on the CPU, where the kernel wrappers
    take their differentiable plain versions, against jax.grad of the JAX
    package on the same theta and dm."""
    qc, jt, tt, dm = _carried("b3lyp-restricted" if case == "hf" else case)
    if case == "hf":
        jfun = functools.partial(jengine.HFEngine().energy, theta=jt)
        tq = dqt.HF(_port_mol("b3lyp-restricted"))
    else:
        jfun = qc.dm2energy
        tq = dqt.KS(_port_mol(case), xc=CASES[case]["xc"])
    tq._theta = tt
    d = torch.tensor(dm, requires_grad=True)
    (g,) = torch.autograd.grad(tq.dm2energy(d), d)
    diff = np.abs(g.numpy() - np.asarray(jax.grad(jfun)(jnp.asarray(dm))))
    assert diff.max() <= 1e-11, diff.max()


def test_ks_of_a_closed_shell_polarized_equals_restricted():
    r = dqt.KS(_port_mol("b3lyp-restricted"), xc="b3lyp").run()
    u = dqt.KS(_port_mol("b3lyp-restricted"), xc="b3lyp",
               restricted=False).run()
    assert isinstance(u.aodm(), dqt.SpinParam)
    assert abs(float(u.energy()) - float(r.energy())) <= 1e-9
    assert abs(float(r.dm2energy(r.aodm())) - float(r.energy())) <= 1e-12
    assert {"int1e_s", "eri_s", "grid_s", "scf_s"} <= set(r.stats)


def test_ks_of_an_lda_matches_jax_functional_energy():
    """svwn through the plain route of the port (no kernel serves an LDA)
    against the JAX engine's energy of the same converged density."""
    qc, jt, tt, dm = _carried("b3lyp-restricted")
    jeng = jengine.KSEngine(jgetxc.get_xc("svwn"))
    teng = tengine.KSEngine(tgetxc.get_xc("svwn"))
    t = teng.energy(torch.as_tensor(dm), tt)
    j = jeng.energy(jnp.asarray(dm), jt)
    assert abs(float(t) - float(j)) <= 1e-11


def test_ks_takes_meta_ggas_and_range_separation_on_the_dense_route(
        monkeypatch):
    """Meta-GGAs and range-separated hybrids build their theta (the grid's
    ao_lapl, one attenuated eri_lr_k per omega); variational=True selects
    the variational solver and an unknown SCF method raises; the long-range
    K without its tensor raises, naming its item. Past the
    dense limit a functional takes the blocked route, and range separation
    whose tensors do not fit the dense route together raises, naming
    mol.densityfit()."""
    mol = _port_mol("b3lyp-restricted")
    qc = dqt.KS(mol, xc="camb3lyp")
    th = qc._build_theta(qc._all_params())
    assert th["eri_lr_k0"].shape == th["eri_k"].shape
    assert not torch.equal(th["eri_lr_k0"], th["eri_k"])
    qc = dqt.KS(mol, xc="scan")
    assert "ao_lapl" in qc._build_theta(qc._all_params())["grid"]
    assert dqt.KS(mol, xc="pbe", variational=True).opts.method == \
        "variational"
    with pytest.raises(ValueError, match="unknown SCF method"):
        dqt.KS(mol, xc="pbe", opts=dqt.SCFOptions(method="newton"))
    # the long-range K needs its attenuated tensor in theta
    with pytest.raises(ValueError, match="eri_lr_k0"):
        tengine.KSEngine(tgetxc.get_xc("camb3lyp"))._k_lr(
            {}, torch.zeros(2, 2), 0)
    nao = mol.meta.nao
    monkeypatch.setattr(tqc.config, "DENSE_ERI_BYTES_LIMIT", nao ** 4 * 8)
    assert dqt.KS(mol, xc="pbe").jk_mode == "dense"   # one tensor fits
    with pytest.raises(NotImplementedError, match=r"mol\.densityfit\(\)"):
        dqt.KS(mol, xc="camb3lyp")               # two do not
    monkeypatch.setattr(tqc.config, "DENSE_ERI_BYTES_LIMIT", 100)
    assert dqt.KS(mol, xc="pbe").jk_mode == "blocked"
    monkeypatch.setattr(tqc.config, "BLOCKED_JK_BYTES_LIMIT", 100)
    assert dqt.KS(mol, xc="pbe").jk_mode == "stream"


def test_jax_theta_is_the_dense_route():
    """The carried theta is the dense route of both packages at this size
    (no kernel planes, no blocked J/K), so the stage tests compare like
    with like."""
    qc, jt, _, _ = _carried("b3lyp-restricted")
    assert "eri" in jt and "dsg" not in jt["grid"] and "eri_dsh" not in jt
    assert jax.default_backend() == "cpu"
