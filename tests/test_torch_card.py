"""PyTorch/CUDA port: tests that need an NVIDIA GPU.

Run them on a machine with a card:

    python -m pytest tests/test_torch_card.py -q

Without a card every test here skips (decided inside the test, not at
import). The file imports the port and PyTorch only, so it also runs where
JAX is not installed. The CUDA kernel has no interpret mode: its plain
PyTorch version `ds_jk_reference` is what it is held against, to the 1e-10
relative gate the JAX package uses for its own kernel on its chip.
"""
import numpy as np
import pytest
import torch

import dqc_tpu_torch as dqt
from dqc_tpu_torch.ops import hopper_jk, hopper_xc
from dqc_tpu_torch.scf.engine import HFEngine
from dqc_tpu_torch.xc import getxc
from dqc_tpu_torch.xc import integrate

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda_card]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only there")


def _eri_like(n, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n, n, n)) * np.exp(
        rng.uniform(-8, 1, (n, n, n, n)))
    t = t + t.transpose(1, 0, 2, 3)
    t = t + t.transpose(0, 1, 3, 2)
    t = t + t.transpose(2, 3, 0, 1)
    return torch.as_tensor(np.ascontiguousarray(t), device="cuda")


def _card_like(n, seed):
    """Seeded (n,n,n,n) tensor with an ERI's spread of magnitudes and no
    symmetry, made on the card (numpy on the host is too slow at n >= 114:
    4 GB at n = 150, 6.8 GB at n = 171)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    t = torch.randn((n,) * 4, generator=g, dtype=torch.float64,
                    device="cuda")
    scale = torch.empty_like(t).uniform_(-8.0, 1.0, generator=g)
    return t.mul_(scale.exp_())


@pytest.mark.parametrize("n", [1, 7, 33, 66, 114, 150, 171])
@pytest.mark.parametrize("symmetric", [True, False])
def test_kernel_matches_plain_version(n, symmetric):
    """Both layouts of the kernel's plan: dm kept in shared memory (n up to
    128 on an H100) and dm's rows streamed with T's (n = 150, 171)."""
    _need_card()
    t = _eri_like(n, seed=n) if n <= 66 else _card_like(n, seed=n)
    rng = np.random.default_rng(3)
    dm = rng.standard_normal((n, n))
    dm = torch.as_tensor(dm + dm.T if symmetric else dm, device="cuda")
    before = hopper_jk.ds_jk.launches
    out = hopper_jk.ds_jk(t, dm)
    again = hopper_jk.ds_jk(t, dm)
    ref = hopper_jk.ds_jk_reference(t, dm)
    torch.cuda.synchronize()
    assert hopper_jk.ds_jk.launches == before + 2
    for a, b, r in zip(out, again, ref):
        assert (a - r).abs().max().item() <= 1e-10 * r.abs().max().item()
        assert torch.equal(a, b)          # no atomics: bit-identical
    del t, ref
    torch.cuda.empty_cache()


def test_kernel_takes_t_that_does_not_start_on_16_bytes():
    """A contiguous view 8 bytes into its storage: the bulk copies take the
    aligned span around each stage (odd n, so rows do not start on 16
    bytes either)."""
    _need_card()
    n = 33
    base = torch.as_tensor(np.random.default_rng(9).standard_normal(
        n ** 4 + 1), device="cuda")
    t = base[1:].view(n, n, n, n)
    assert t.is_contiguous() and t.data_ptr() % 16 == 8
    dm = torch.as_tensor(np.random.default_rng(10).standard_normal((n, n)),
                         device="cuda")
    out = hopper_jk.ds_jk(t, dm)
    ref = hopper_jk.ds_jk_reference(t, dm)
    for a, r in zip(out, ref):
        assert (a - r).abs().max().item() <= 1e-10 * r.abs().max().item()


def test_kernel_refuses_non_contiguous_and_wrong_dtype():
    _need_card()
    t = _eri_like(6, seed=1)
    dm = torch.eye(6, dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError):
        hopper_jk.ds_jk(t.permute(0, 2, 1, 3), dm)
    with pytest.raises(TypeError):
        hopper_jk.ds_jk(t.float(), dm.float())
    with pytest.raises(ValueError):
        hopper_jk.ds_jk(t, dm.cpu())


def test_hf_runs_on_the_card_by_default():
    _need_card()
    mol = dqt.Mol("H -0.5 0 0; H 0.5 0 0", basis="3-21G")
    assert mol.device.type == "cuda"
    hopper_jk.ds_jk.launches = 0
    qc = dqt.HF(mol).run()
    assert hopper_jk.ds_jk.launches >= qc.stats["iterations"] + 1
    assert abs(float(qc.energy()) - (-1.07195346)) < 1e-6
    cpu = dqt.HF(dqt.Mol("H -0.5 0 0; H 0.5 0 0", basis="3-21G",
                         device="cpu")).run()
    assert abs(float(qc.energy()) - float(cpu.energy())) < 1e-10


def test_engine_jk_parts_goes_through_the_kernel():
    _need_card()
    n = 10
    t = _eri_like(n, seed=4)
    rng = np.random.default_rng(5)
    dm = rng.standard_normal((2, n, n))
    dm = torch.as_tensor(dm + dm.transpose(0, 2, 1), device="cuda")
    hopper_jk.ds_jk.launches = 0
    j, k = HFEngine(polarized=True).jk_parts(dm, {"eri_k": t})
    assert hopper_jk.ds_jk.launches == 2
    jr = torch.einsum("ikjl,kl->ij", t, dm.sum(0))
    kr = torch.einsum("ijkl,skl->sij", t, dm)
    assert (j - jr).abs().max().item() <= 1e-10 * jr.abs().max().item()
    assert (k - kr).abs().max().item() <= 1e-10 * kr.abs().max().item()


# --- K2 / K3: grid density and V_xc assembly of a GGA -----------------------

def _tables(ng, nao, seed):
    """AO-like tables with a wide spread of magnitudes (the generator of
    tests/test_pallas_xc.py), on the card."""
    rng = np.random.default_rng(seed)
    ao = rng.standard_normal((ng, nao)) * np.exp(rng.uniform(-6, 2, (ng, nao)))
    ag = rng.standard_normal((3, ng, nao)) * np.exp(
        rng.uniform(-6, 2, (3, ng, nao)))
    return (torch.as_tensor(ao, device="cuda"),
            torch.as_tensor(ag, device="cuda"))


def _rel(a, r):
    return (a - r).abs().max().item() / r.abs().max().item()


@pytest.mark.parametrize("ng,nao", [(1, 1), (100, 10), (700, 26),
                                    (1234, 65), (5000, 150), (33, 7),
                                    (3000, 300)])
@pytest.mark.parametrize("symmetric", [True, False])
def test_dens_kernel_matches_plain_version(ng, nao, symmetric):
    _need_card()
    ao, ag = _tables(ng, nao, seed=ng)
    rng = np.random.default_rng(nao)
    dm = rng.standard_normal((nao, nao))
    dm = torch.as_tensor(dm + dm.T if symmetric else dm, device="cuda")
    before = hopper_xc.ds_dens_gga.launches
    out = hopper_xc.ds_dens_gga(ao, ag, dm)
    again = hopper_xc.ds_dens_gga(ao, ag, dm)
    ref = hopper_xc.ds_dens_reference(ao, ag, dm)
    torch.cuda.synchronize()
    assert hopper_xc.ds_dens_gga.launches == before + 2
    for a, b, r in zip(out, again, ref):
        assert a.shape == r.shape
        assert _rel(a, r) <= 1e-10
        assert torch.equal(a, b)          # no atomics: bit-identical


@pytest.mark.parametrize("ng,nao", [(1, 1), (100, 10), (700, 26),
                                    (1234, 65), (5000, 150), (33, 7),
                                    (3000, 300)])
def test_vxc_kernel_matches_plain_version(ng, nao):
    """One sub-block of V (nao <= 128), two (150) and three panels a side
    (300); (33, 7) has ng nao odd, so ao_grad's tables do not start on 16
    bytes."""
    _need_card()
    ao, ag = _tables(ng, nao, seed=ng + 1)
    rng = np.random.default_rng(nao + 1)
    vr = torch.as_tensor(rng.standard_normal(ng), device="cuda")
    vg = torch.as_tensor(rng.standard_normal((3, ng)), device="cuda")
    before = hopper_xc.ds_vxc_gga.launches
    v = hopper_xc.ds_vxc_gga(ao, ag, vr, vg)
    again = hopper_xc.ds_vxc_gga(ao, ag, vr, vg)
    ref = hopper_xc.ds_vxc_reference(ao, ag, vr, vg)
    torch.cuda.synchronize()
    assert hopper_xc.ds_vxc_gga.launches == before + 2
    assert v.shape == (nao, nao)
    assert _rel(v, ref) <= 1e-10
    assert torch.equal(v, again)


def test_vxc_kernel_takes_tables_that_do_not_start_on_16_bytes():
    """Contiguous views 8 bytes into their storage (nao even, so only the
    storage offset keeps the kernel off its 16-byte copies)."""
    _need_card()
    ng, nao = 700, 26
    rng = np.random.default_rng(12)

    def shifted(*shape):
        base = torch.as_tensor(rng.standard_normal(int(np.prod(shape)) + 1),
                               device="cuda")
        t = base[1:].view(*shape)
        assert t.is_contiguous() and t.data_ptr() % 16 == 8
        return t
    ao, ag, vr, vg = shifted(ng, nao), shifted(3, ng, nao), shifted(ng), \
        shifted(3, ng)
    v = hopper_xc.ds_vxc_gga(ao, ag, vr, vg)
    again = hopper_xc.ds_vxc_gga(ao, ag, vr, vg)
    ref = hopper_xc.ds_vxc_reference(ao, ag, vr, vg)
    torch.cuda.synchronize()
    assert _rel(v, ref) <= 1e-10
    assert torch.equal(v, again)


def test_xc_kernels_refuse_autograd_and_bad_inputs():
    """Under autograd the kernels' backward launches the other kernel (K2's
    dm cotangent is K3, K3's potential cotangents are K2) and agrees with
    autograd of the plain versions (1e-10 relative); bad inputs raise."""
    _need_card()
    ao, ag = _tables(50, 7, seed=3)
    rng = np.random.default_rng(4)
    dm = torch.as_tensor(rng.standard_normal((7, 7)), device="cuda")
    vr = torch.as_tensor(rng.standard_normal(50), device="cuda")
    vg = torch.as_tensor(rng.standard_normal((3, 50)), device="cuda")
    for fn, plain, args, kernel in (
            (hopper_xc.ds_dens_gga, hopper_xc.ds_dens_reference,
             (ao, ag, dm), hopper_xc.ds_vxc_gga),
            (hopper_xc.ds_vxc_gga, hopper_xc.ds_vxc_reference,
             (ao, ag, vr, vg), hopper_xc.ds_dens_gga)):
        grads = []
        for f in (fn, plain):
            xs = [a.clone().requires_grad_(True) for a in args]
            out = f(*xs)
            out = out if isinstance(out, tuple) else (out,)
            before = kernel.launches
            grads.append(torch.autograd.grad(
                sum((o * (i + 1.0)).sum() for i, o in enumerate(out)), xs))
            if f is fn:
                assert kernel.launches == before + 1
        for a, r in zip(*grads):
            assert _rel(a, r) <= 1e-10
    with pytest.raises(TypeError):
        hopper_xc.ds_dens_gga(ao.float(), ag.float(), dm.float())
    with pytest.raises(ValueError):
        hopper_xc.ds_vxc_gga(ao.t(), ag, vr, vg)
    with pytest.raises(ValueError):
        hopper_xc.ds_dens_gga(ao, ag, dm.cpu())


H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"


def test_xc_on_the_card_takes_the_kernels_on_a_grid_beyond_the_chunk(
        monkeypatch):
    """The CPU's chunk limit bounds the plain versions' intermediates only:
    on the card a grid longer than it still goes whole through K2 and K3,
    also when the call is differentiated (through the kernels' backward)."""
    _need_card()
    mol = dqt.Mol(H2O, basis="3-21G", grid=1)
    tabs = integrate.setup_grid_theta(mol.meta, mol.params,
                                      mol.setup_grid(), family=2)
    ng = tabs["dvol"].shape[0]
    monkeypatch.setattr(integrate, "_chunk_size", lambda nao: 1000)
    assert ng > 1000
    xc = getxc.get_xc("b3lyp")
    rng = np.random.default_rng(8)
    a = rng.standard_normal((mol.meta.nao,) * 2) * 0.1
    dm = torch.as_tensor(a @ a.T, device="cuda")
    hopper_xc.ds_dens_gga.launches = hopper_xc.ds_vxc_gga.launches = 0
    e, v = integrate.exc_vxc(xc, dm, tabs, False)
    e2 = integrate.exc_energy(xc, dm, tabs, False)
    torch.cuda.synchronize()
    assert hopper_xc.ds_dens_gga.launches == 2
    assert hopper_xc.ds_vxc_gga.launches == 1
    cpu = {k: (t.cpu() if torch.is_tensor(t) else t) for k, t in tabs.items()}
    ec, vc = integrate.exc_vxc(xc, dm.cpu(), cpu, False)   # chunked
    assert abs(float(e) - float(ec)) <= 1e-11
    assert abs(float(e2) - float(ec)) <= 1e-11
    assert (v.cpu() - vc).abs().max().item() <= 1e-11
    before = hopper_xc.ds_vxc_gga.launches
    vad = integrate.vxc_matrix_ad(xc, dm, tabs, False)
    assert hopper_xc.ds_vxc_gga.launches == before + 1
    assert (vad.cpu() - vc).abs().max().item() <= 1e-11


def test_ks_runs_on_the_card_through_all_three_kernels():
    _need_card()
    h2o = H2O
    mol = dqt.Mol(h2o, basis="3-21G", grid=1)
    assert mol.device.type == "cuda"
    hopper_jk.ds_jk.launches = 0
    hopper_xc.ds_dens_gga.launches = hopper_xc.ds_vxc_gga.launches = 0
    qc = dqt.KS(mol, xc="b3lyp").run()
    n = qc.stats["iterations"]
    assert hopper_jk.ds_jk.launches >= n + 1
    assert hopper_xc.ds_dens_gga.launches >= n + 1
    assert hopper_xc.ds_vxc_gga.launches >= n
    cpu = dqt.KS(dqt.Mol(h2o, basis="3-21G", grid=1, device="cpu"),
                 xc="b3lyp").run()
    assert abs(float(qc.energy()) - float(cpu.energy())) < 1e-10


def test_forces_and_hvp_on_the_card_match_the_cpu():
    """energy_grad and energy_hvp of B3LYP H2O/3-21G (grid 1, off its
    mirror plane) on the card against the same calls on the CPU: forces to
    1e-10 Ha/Bohr, the Hessian-vector product to 1e-9; all three kernels
    launch inside each."""
    _need_card()
    desc = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0.1 -1.4309 -0.8867"
    out = {}
    for dev in ("cuda", "cpu"):
        mol = dqt.Mol(desc, basis="3-21G", grid=1, device=dev)
        qc = dqt.KS(mol, xc="b3lyp", opts=dqt.SCFOptions(tol=1e-11)).run()
        p = qc._all_params()
        d = torch.as_tensor(np.random.default_rng(3).standard_normal(
            p["basis"]["atompos"].shape), device=dev)
        v = qc._like(p, [None] * 64)
        v["basis"] = dict(v["basis"], atompos=d)
        launches = []
        for call in (lambda: qc.energy_grad(), lambda: qc.energy_hvp(v)):
            hopper_jk.ds_jk.launches = 0
            hopper_xc.ds_dens_gga.launches = 0
            hopper_xc.ds_vxc_gga.launches = 0
            r = call()["basis"]["atompos"].cpu()
            launches.append((hopper_jk.ds_jk.launches,
                             hopper_xc.ds_dens_gga.launches,
                             hopper_xc.ds_vxc_gga.launches))
            out.setdefault(dev, []).append(r)
        if dev == "cuda":
            assert all(n > 0 for row in launches for n in row), launches
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-10
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 1e-9


def test_k1_on_the_erf_attenuated_eri_matches_plain_version():
    """K1 on the erf-attenuated ERI of H2O/def2-SVP (omega 0.33) in the
    exchange layout: the long-range K of the range-separated hybrids,
    counted under its tag; the dm cotangent's pair-symmetry probe holds."""
    _need_card()
    from dqc_tpu_torch.ops.eri import eri_dense
    mol = dqt.Mol(H2O, basis="def2-svp")
    t = eri_dense(mol.meta, mol.params, omega=0.33).permute(
        0, 2, 1, 3).contiguous()
    t.jk_tag = "eri_lr"
    n = t.shape[0]
    rng = np.random.default_rng(5)
    dm = rng.standard_normal((n, n))
    dm = torch.as_tensor(dm + dm.T, device="cuda")
    hopper_jk.ds_jk.launches_by_tag.clear()
    out = hopper_jk.ds_jk(t, dm)
    ref = hopper_jk.ds_jk_reference(t, dm)
    assert hopper_jk.ds_jk.launches_by_tag == {"eri_lr": 1}
    for a, r in zip(out, ref):
        assert (a - r).abs().max().item() <= 1e-10 * r.abs().max().item()
    hopper_jk._assert_pair_symmetric(t)


def test_cam_b3lyp_gradient_on_the_card_matches_central_differences():
    """CAM-B3LYP H2O/STO-3G forces by implicit differentiation on the card
    (K1 on eri_k and eri_lr_k0 in the SCF and in the gradient) against
    central differences of the energy (h = 1e-4 Bohr): 1e-7 Ha/Bohr."""
    _need_card()
    desc = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0.1 -1.4309 -0.8867"
    mol = dqt.Mol(desc, basis="sto-3g", grid=1)
    qc = dqt.KS(mol, xc="camb3lyp", opts=dqt.SCFOptions(tol=1e-11))
    hopper_jk.ds_jk.launches_by_tag.clear()
    g = qc.energy_grad()["basis"]["atompos"]
    assert hopper_jk.ds_jk.launches_by_tag.get("eri_lr", 0) > 0
    p0 = qc._all_params()
    pos0 = p0["basis"]["atompos"]
    h = 1e-4
    for atom, axis in ((0, 2), (2, 0)):
        es = []
        for sgn in (1, -1):
            pos = pos0.clone()
            pos[atom, axis] += sgn * h
            with torch.no_grad():
                es.append(float(qc.energy_fn(
                    dict(p0, basis=dict(p0["basis"], atompos=pos)))))
        fd = (es[0] - es[1]) / (2 * h)
        assert abs(fd - float(g[atom, axis])) <= 1e-7


def test_k_lr_on_the_card_launches_k1_or_raises():
    _need_card()
    from dqc_tpu_torch.scf.engine import KSEngine
    eng = KSEngine(getxc.get_xc("camb3lyp"))
    t = _eri_like(7, seed=3).permute(0, 2, 1, 3).contiguous()
    dm = torch.eye(7, dtype=torch.float64, device="cuda")
    before = hopper_jk.ds_jk.launches
    k = eng._k_lr({"eri_lr_k0": t}, dm, 0)
    assert hopper_jk.ds_jk.launches == before + 1
    assert torch.allclose(k, hopper_jk.ds_jk_reference(t, dm)[0],
                          rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        eng._k_lr({"eri_lr_k0": t}, dm.cpu(), 0)


def test_df_b3lyp_on_the_card_launches_k2_k3_and_no_k1():
    """H2O/def2-SVP B3LYP on the density-fitted route (grid 1): K2 and K3
    once per Fock build (and K2 once more for the energy), K1 never (H2O is
    below the SAD size, so no atomic SCF runs), theta without eri_k; the
    energy equals the same call on the CPU to 1e-10 Ha."""
    _need_card()
    mol = dqt.Mol(H2O, basis="def2-svp", grid=1).densityfit()
    hopper_jk.ds_jk.launches = 0
    hopper_xc.ds_dens_gga.launches = hopper_xc.ds_vxc_gga.launches = 0
    qc = dqt.KS(mol, xc="b3lyp").run()
    builds = qc.stats["iterations"] + 1
    assert "eri_k" not in qc._theta and "df" in qc._theta
    assert hopper_jk.ds_jk.launches == 0
    assert hopper_xc.ds_dens_gga.launches == builds + 1
    assert hopper_xc.ds_vxc_gga.launches == builds
    cpu = dqt.KS(dqt.Mol(H2O, basis="def2-svp", grid=1,
                         device="cpu").densityfit(), xc="b3lyp").run()
    assert abs(float(qc.energy()) - float(cpu.energy())) < 1e-10


def test_blocked_b3lyp_on_the_card_launches_k2_k3_and_no_k1(monkeypatch):
    """H2O/def2-SVP B3LYP on the blocked route (the dense limit set to 0,
    grid 1): K2 and K3 once per Fock build (and K2 once more for the
    energy), K1 never (H2O is below the SAD size); the same blocks and dm
    contracted twice give the same bits; the energy equals the dense route's
    on the card to 1e-10 Ha."""
    _need_card()
    from dqc_tpu_torch.scf import qccalc
    mol = dqt.Mol(H2O, basis="def2-svp", grid=1)
    dense = dqt.KS(mol, xc="b3lyp").run()
    monkeypatch.setattr(qccalc.config, "DENSE_ERI_BYTES_LIMIT", 0)
    hopper_jk.ds_jk.launches = 0
    hopper_xc.ds_dens_gga.launches = hopper_xc.ds_vxc_gga.launches = 0
    qc = dqt.KS(mol, xc="b3lyp").run()
    builds = qc.stats["iterations"] + 1
    assert qc.jk_mode == "blocked" and "jkb0" in qc._theta
    assert hopper_jk.ds_jk.launches == 0
    assert hopper_xc.ds_dens_gga.launches == builds + 1
    assert hopper_xc.ds_vxc_gga.launches == builds
    dm = qc.aodm().contiguous()
    with torch.no_grad():
        j1, k1 = qc.engine.jk_parts(dm, qc._theta)
        j2, k2 = qc.engine.jk_parts(dm, qc._theta)
    assert torch.equal(j1, j2) and torch.equal(k1, k2)
    assert abs(float(qc.energy()) - float(dense.energy())) < 1e-10


def _launches():
    return (hopper_jk.ds_jk.launches, hopper_xc.ds_dens_gga.launches,
            hopper_xc.ds_vxc_gga.launches)


def _zero_launches():
    hopper_jk.ds_jk.launches = 0
    hopper_xc.ds_dens_gga.launches = hopper_xc.ds_vxc_gga.launches = 0


H2O_CCCBDB = "O 0.0 0.0 0.2156; H 0.0 1.4749 -0.8625; H 0.0 -1.4749 -0.8625"


def test_hf_properties_on_the_card_match_the_cpu():
    """hessian_pos, polarizability, the dipole and the Raman activities
    (a third derivative) of HF H2O/STO-3G on the card against the same
    calls on the CPU, each to 1e-9 of its largest entry; K1 launches
    inside the second- and third-order calls."""
    _need_card()
    from dqc_tpu_torch.api import properties as P
    out = {}
    for dev in ("cuda", "cpu"):
        mol = dqt.Mol(H2O_CCCBDB, basis="sto-3g", device=dev)
        qc = dqt.HF(mol, opts=dqt.SCFOptions(tol=1e-11)).run()
        res = {}
        for name, fn in (("hessian", P.hessian_pos),
                         ("alpha", P.polarizability), ("mu", P.edipole),
                         ("raman", lambda q: P.raman_spectrum(q)[1][:3])):
            _zero_launches()
            res[name] = fn(qc).cpu()
            if dev == "cuda" and name in ("hessian", "alpha", "raman"):
                assert hopper_jk.ds_jk.launches > 0, name
        out[dev] = res
    for name, ref in out["cpu"].items():
        err = (out["cuda"][name] - ref).abs().max().item()
        assert err <= 1e-9 * ref.abs().max().item(), (name, err)


def test_b3lyp_third_derivative_on_the_card_matches_the_cpu():
    """dalpha/dR of B3LYP H2O/3-21G (grid 1): a third derivative through
    the SCF whose backwards run K1-K3 on the card, against the CPU to 1e-9
    of its largest entry."""
    _need_card()
    from dqc_tpu_torch.api import properties as P
    out = {}
    for dev in ("cuda", "cpu"):
        mol = dqt.Mol(H2O, basis="3-21G", grid=1, device=dev)
        qc = dqt.KS(mol, xc="b3lyp", opts=dqt.SCFOptions(tol=1e-11)).run()
        _zero_launches()
        out[dev] = P._dalpha_dpos(qc)[1].cpu()
        if dev == "cuda":
            assert all(n > 0 for n in _launches()), _launches()
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    assert err <= 1e-9 * out["cpu"].abs().max().item()


def test_variational_b3lyp_on_the_card_matches_diis():
    """B3LYP H2O/3-21G (grid 1) by the variational solver ("ov") on the
    card against the DIIS energy to 1e-9 Ha; K1-K3 launch in its energy
    and gradient evaluations."""
    _need_card()
    mol = dqt.Mol(H2O, basis="3-21G", grid=1)
    e_diis = float(dqt.KS(mol, xc="b3lyp").run().energy())
    _zero_launches()
    qc = dqt.KS(mol, xc="b3lyp", variational=True,
                opts=dqt.SCFOptions(orb_param="ov")).run()
    assert all(n > 0 for n in _launches()), _launches()
    assert abs(float(qc.energy()) - e_diis) <= 1e-9


def test_vext_and_dm2dens_on_the_card_match_the_cpu():
    """HF H2/STO-3G with a seeded potential on its level-1 grid: the energy
    on the card against the CPU to 1e-10 Ha, dm2dens at the grid points to
    1e-12."""
    _need_card()
    desc = "H -0.7 0 0; H 0.7 0 0"
    ng = dqt.Mol(desc, basis="sto-3g", grid=1,
                 device="cpu").setup_grid().w0.shape[0]
    v = 0.01 * np.random.default_rng(0).standard_normal(ng)
    res = {}
    for dev in ("cuda", "cpu"):
        mol = dqt.Mol(desc, basis="sto-3g", grid=1, vext=v, device=dev)
        qc = dqt.HF(mol).run()
        pts = integrate.setup_grid_theta(mol.meta, mol.params,
                                         mol.setup_grid())["coords"]
        res[dev] = (float(qc.energy()), qc.dm2dens(pts).cpu())
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-10
    assert (res["cuda"][1] - res["cpu"][1]).abs().max().item() <= 1e-12


def test_first_gradient_on_the_card_frees_its_calc():
    """As tests/test_torch_grad.py's CPU test, on the card: in a fresh
    interpreter with the cyclic garbage collector off, the calc of the
    first energy_grad is freed when the caller drops it."""
    _need_card()
    import os
    import subprocess
    import sys
    code = "\n".join([
        "import gc, weakref",
        "gc.disable()",
        "import dqc_tpu_torch as dq",
        f"qc = dq.HF(dq.Mol({H2O!r}, basis='sto-3g'))",
        "g = qc.energy_grad()",
        "ref = weakref.ref(qc)",
        "del qc, g",
        "print('calc alive:', ref() is not None)"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "calc alive: False"


@pytest.mark.parametrize("nb,n", [(3, 7), (2, 33), (2, 150)])
def test_batched_k1_matches_plain_version_in_one_launch(nb, n):
    """K1 with a batch axis (dm in shared memory at n <= 128, streamed
    beside T above): each member within 1e-10 of the plain version, one
    launch for the batch, the batch of one bit for bit the unbatched
    call."""
    _need_card()
    T = torch.stack([(_eri_like(n, m) if n <= 33 else _card_like(n, m))
                     for m in range(nb)])
    dm = torch.as_tensor(np.random.default_rng(n).standard_normal(
        (nb, n, n)), device="cuda")
    before = hopper_jk.ds_jk.launches
    out = hopper_jk.ds_jk(T, dm)
    assert hopper_jk.ds_jk.launches == before + 1
    ref = hopper_jk.ds_jk_reference(T, dm)
    for a, r in zip(out, ref):
        for m in range(nb):
            assert float((a[m] - r[m]).abs().max()
                         / r[m].abs().max()) <= 1e-10
    one = hopper_jk.ds_jk(T[:1], dm[:1])
    single = hopper_jk.ds_jk(T[0], dm[0])
    assert all(torch.equal(x[0], y) for x, y in zip(one, single))


@pytest.mark.parametrize("nb,ng,nao", [(3, 33, 7), (2, 700, 26),
                                       (2, 3000, 300)])
def test_batched_xc_kernels_match_plain_version_in_one_launch(nb, ng, nao):
    _need_card()
    rng = np.random.default_rng(ng)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device="cuda")
    ao, ag, dm = t(nb, ng, nao), t(nb, 3, ng, nao), t(nb, nao, nao)
    vr, vg = t(nb, ng), t(nb, 3, ng)
    d0, v0 = hopper_xc.ds_dens_gga.launches, hopper_xc.ds_vxc_gga.launches
    dens = hopper_xc.ds_dens_gga(ao, ag, dm)
    v = hopper_xc.ds_vxc_gga(ao, ag, vr, vg)
    assert hopper_xc.ds_dens_gga.launches == d0 + 1
    assert hopper_xc.ds_vxc_gga.launches == v0 + 1
    refs = hopper_xc.ds_dens_reference(ao, ag, dm) + (
        hopper_xc.ds_vxc_reference(ao, ag, vr, vg),)
    for a, r in zip(dens + (v,), refs):
        for m in range(nb):
            assert float((a[m] - r[m]).abs().max()
                         / r[m].abs().max()) <= 1e-10


@pytest.mark.parametrize("nb,nk,ng,nao", [(2, 3, 700, 26), (3, 2, 3001, 7)])
def test_xc_kernels_read_strided_member_views_in_place(nb, nk, ng, nao):
    """The members' tables at one k-point of (B, nk, ...) stacks, a view
    whose member stride is nk ng nao (odd ng nao for one case: the bulk
    copies take the aligned span around it), and potentials shared by the
    members (member stride 0): bit for bit the call on contiguous copies,
    and within 1e-10 of the plain version; a view whose members are not
    contiguous raises."""
    _need_card()
    rng = np.random.default_rng(nk * ng)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device="cuda")
    ao_k, ag_k, dm = t(nb, nk, ng, nao), t(nb, nk, 3, ng, nao), t(nb, nao,
                                                                   nao)
    ao, ag = ao_k[:, 1], ag_k[:, 1]
    vr, vg = t(1, ng).expand(nb, -1), t(1, 3, ng).expand(nb, -1, -1)
    aoc, agc = ao.contiguous(), ag.contiguous()
    dens = hopper_xc.ds_dens_gga(ao, ag, dm)
    v = hopper_xc.ds_vxc_gga(ao, ag, vr, vg)
    dens_c = hopper_xc.ds_dens_gga(aoc, agc, dm)
    v_c = hopper_xc.ds_vxc_gga(aoc, agc, vr.contiguous(), vg.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(dens + (v,), dens_c + (v_c,)))
    refs = hopper_xc.ds_dens_reference(ao, ag, dm) + (
        hopper_xc.ds_vxc_reference(ao, ag, vr, vg),)
    for a, r in zip(dens + (v,), refs):
        for m in range(nb):
            assert float((a[m] - r[m]).abs().max()
                         / r[m].abs().max()) <= 1e-10
    bad = ao.mT.contiguous().mT          # each member column-major
    with pytest.raises(ValueError, match="member"):
        hopper_xc.ds_dens_gga(bad, ag, dm)
