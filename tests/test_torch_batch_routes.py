"""PyTorch/CUDA port: a batch on every route (parallel/batch.energy_batch)
on the CPU.

Each case runs two members, made from a numpy seed (SEED: the system's
positions plus SIGMA Bohr of seeded noise), through one batched SCF:
  - the blocked route (H2O/STO-3G HF and B3LYP, the dense limit set to 0),
    a periodic cell at the Gamma point (H2 in a 3-Bohr cube, the two-s
    SOFT_H basis: HF and LDA on the pair-transform route, HF on the
    periodic fit) and with k-points (LDA at two k-points: He/STO-3G in a
    3-Bohr cube, the setup of tests/test_parallel.py:140-170, whose
    displaced members are the same cell translated; and the H2 cell,
    whose members differ): against jax.vmap of the JAX package's
    energy_fn on the same positions, within 1e-10 Ha. The vmapped JAX
    calls take 10-57 s each on one core, so
    their values are stored (JAX_VMAP_HA, printed by
    `JAX_PLATFORMS=cpu python tests/torch_anchor_report.py --factored
    batch_routes`: the JAX package's blocked route with its
    DENSE_ERI_BYTES_LIMIT set to 0 for the run, its periodic fit
    contracted in factored form as the port's);
  - the streamed route (H2O/STO-3G HF and B3LYP, and three B3LYP
    members whose outer cycles stop apart), a k-point GGA (PBE on the H2
    cell, K2/K3's plain versions on the members' strided table views) and
    two
    polarized batches (blocked UHF, Gamma UKS-PBE0): against the port's
    unbatched energy_fn, 1e-10 Ha;
  - the variational solver ("ov" and "matexp", H2O/STO-3G HF): against
    the port's unbatched variational energies, 1e-9 Ha;
  - the position gradient of a Gamma batch's summed energies (HF on the
    pair transforms) against the sum of the members' energy_grad, 1e-9
    relative;
  - the member at the system's own geometry gets the unbatched theta bit
    for bit, and a displaced member the theta built from its own params;
    a part whose shape differs raises, naming it;
  - K2/K3's plain versions on a strided member view (the members' tables
    at one k-point) equal the call on a contiguous copy bit for bit, and a
    member stride of 0 (potentials shared by the members) equals the
    explicit copies, and the layouts the kernels take on the card;
  - convert.batch_params_from_numpy on a Sol's params tree.
"""
import numpy as np
import pytest
import torch

import dqc_tpu_torch as dqt
from dqc_tpu_torch.convert import batch_params_from_numpy
from dqc_tpu_torch.ops import hopper_xc
from dqc_tpu_torch.parallel import batch as pbatch
from dqc_tpu_torch.parallel.batch import energy_batch
from dqc_tpu_torch.utils.config import config
from dqc_tpu_torch.utils.datastruct import batch_params, member_params

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

SEED = 15
SIGMA = 0.05
WATER = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
SOFT_H = """H      0
S    1   1.00
      0.90    1.0
S    1   1.00
      0.25    1.0
****
"""
GAMMA_CELL = dict(soldesc="H 0 0 0; H 1.4 0 0", alattice=np.eye(3) * 3.0,
                  basis=SOFT_H, grid=0)
K_CELL = dict(soldesc="He 0 0 0", alattice=np.eye(3) * 3.0, basis="sto-3g",
              grid=0, kpts=np.array([[0.0, 0.0, 0.0], [np.pi / 3.0, 0, 0]]))
# H2 (the two-s SOFT_H basis) at the same k-points: displacing one He atom
# only translates it, so its members have the same energy; H2's do not
K_H2_CELL = dict(K_CELL, soldesc="H 0 0 0; H 1.4 0 0", basis=SOFT_H)
CELLS = {"gamma": GAMMA_CELL, "kpt": K_CELL, "kpt_h2": K_H2_CELL}
# (system, xc, route): "blocked" molecules, "aft"/"gdf" Gamma cells and
# "kpt" cells; xc None is HF
JAX_CASES = {"blocked_hf": ("water", None, "blocked"),
             "blocked_b3lyp": ("water", "b3lyp", "blocked"),
             "gamma_hf": ("gamma", None, "aft"),
             "gamma_lda": ("gamma", "lda_x", "aft"),
             "gamma_gdf_hf": ("gamma", None, "gdf"),
             "kpt_lda": ("kpt", "lda_x", "aft"),
             "kpt_h2_lda": ("kpt_h2", "lda_x", "aft")}
# jax.vmap(energy_fn) of the JAX package at member_positions (module
# docstring), Ha
JAX_VMAP_HA = {
    "blocked_hf": [-74.96178846451375, -74.95587505002197],
    "blocked_b3lyp": [-75.31187126269434, -75.30161130264959],
    "gamma_hf": [-2.131400889633203, -2.129665307782039],
    "gamma_lda": [-1.8127407276480065, -1.8110808634875608],
    "gamma_gdf_hf": [-2.1314100916569587, -2.1296740842433337],
    "kpt_lda": [-3.008866731428172, -3.008866731428186],
    "kpt_h2_lda": [-1.2765178576862382, -1.2823372945023077],
}


def member_positions(pos0):
    """The two members' positions: pos0 (natom, 3) plus SIGMA Bohr of
    seeded noise each."""
    rng = np.random.default_rng(SEED)
    return np.asarray(pos0) + SIGMA * rng.standard_normal(
        (2,) + np.shape(pos0))


def port_calc(system, xc, route, opts=None):
    """The port's calc of a case on the CPU; a molecule's route forced by
    the limits of utils.config, restored after."""
    if system == "water":
        old = (config.DENSE_ERI_BYTES_LIMIT, config.BLOCKED_JK_BYTES_LIMIT)
        config.DENSE_ERI_BYTES_LIMIT = 0
        if route == "stream":
            config.BLOCKED_JK_BYTES_LIMIT = 0
        try:
            mol = dqt.Mol(WATER, basis="sto-3g", grid=0, device="cpu")
            qc = (dqt.HF(mol, opts=opts) if xc is None
                  else dqt.KS(mol, xc=xc, opts=opts))
        finally:
            config.DENSE_ERI_BYTES_LIMIT, config.BLOCKED_JK_BYTES_LIMIT = old
        assert qc.jk_mode == route
        return qc
    cell = dict(CELLS[system])
    desc, a = cell.pop("soldesc"), cell.pop("alattice")
    sol = dqt.Sol(desc, a, device="cpu", **cell)
    if route == "gdf":
        sol.densityfit(method="gdf")
    qc = (dqt.HF(sol, opts=opts) if xc is None
          else dqt.KS(sol, xc=xc, opts=opts))
    assert qc.jk_mode == route
    return qc


def _batch(qc):
    p0 = qc._all_params()
    return batch_params(p0, member_positions(p0["basis"]["atompos"].numpy()))


# --- against jax.vmap of the JAX package's energy_fn -----------------------

@pytest.mark.parametrize("case", list(JAX_CASES))
def test_batch_matches_jax_vmap(case):
    qc = port_calc(*JAX_CASES[case])
    st = {}
    with torch.no_grad():
        es = energy_batch(qc, _batch(qc), st)
    assert es.shape == (2,) and st["batch"] == 2
    assert max(st["residual"]) <= qc.opts.tol
    np.testing.assert_allclose(es.numpy(), JAX_VMAP_HA[case], rtol=0,
                               atol=1e-10)
    if case == "blocked_hf":
        # the stack's bytes of quartet blocks, two members' worth
        from dqc_tpu_torch.scf.jk import jk_blocks_nbytes
        assert st["jk_blocks_bytes_batch"] == 2 * jk_blocks_nbytes(
            qc.engine.jk_info[1])


# --- against the port's own unbatched energy_fn ----------------------------

@pytest.mark.parametrize("case", ["stream_hf", "stream_b3lyp", "kpt_pbe",
                                  "blocked_uhf", "gamma_uks_pbe0"])
def test_batch_matches_the_members_energy_fn(case):
    """The streamed route (one exact build per running member per outer
    cycle, per-member stops), a k-point GGA (one batched K2/K3 call per
    k-point over the members' strided table views), and polarized batches
    (the blocked route's UHF of the H2O triplet, UKS-PBE0 of the Gamma
    cell): each member within 1e-10 Ha of the unbatched energy_fn at its
    geometry."""
    if case.startswith("stream"):
        qc = port_calc("water", None if case == "stream_hf" else "b3lyp",
                       "stream")
    elif case == "kpt_pbe":
        qc = port_calc("kpt_h2", "pbe", "aft")
    elif case == "blocked_uhf":
        old = config.DENSE_ERI_BYTES_LIMIT
        config.DENSE_ERI_BYTES_LIMIT = 0
        try:
            qc = dqt.HF(dqt.Mol(WATER, basis="sto-3g", spin=2, device="cpu"))
        finally:
            config.DENSE_ERI_BYTES_LIMIT = old
        assert qc.jk_mode == "blocked" and qc.engine.polarized
    else:
        cell = dict(GAMMA_CELL)
        desc, a = cell.pop("soldesc"), cell.pop("alattice")
        qc = dqt.KS(dqt.Sol(desc, a, device="cpu", **cell), xc="pbe0",
                    restricted=False)
    pb = _batch(qc)
    st = {}
    with torch.no_grad():
        es = energy_batch(qc, pb, st)
        last = qc._last_jk
        for m in range(2):
            em = qc.energy_fn(member_params(pb, m))
            assert abs(float(es[m]) - float(em)) <= 1e-10
    if case.startswith("stream"):
        # per member: the RI and dual-level records, the exact builds and
        # the best iterate's (dm, J, K)
        for key in ("ri_iterations", "dual_inner_iterations", "exact_jk",
                    "iterations", "residual"):
            assert len(st[key]) == 2
        assert all(r["builds"] >= 1 for r in st["exact_jk"])
        assert len(last) == 2 and all(len(x) == 3 for x in last)


def test_stream_members_that_stop_apart():
    """Three streamed B3LYP members whose exact outer cycles stop apart
    (0.3 Bohr of seeded noise on one): the members still running go on as
    a sub-batch; each within 1e-10 Ha of its unbatched energy_fn."""
    qc = port_calc("water", "b3lyp", "stream")
    p0 = qc._all_params()
    pos0 = p0["basis"]["atompos"].numpy()
    rng = np.random.default_rng(3)
    pb = batch_params(p0, np.stack([
        pos0, pos0 + 0.3 * rng.standard_normal(pos0.shape),
        pos0 + 0.01 * rng.standard_normal(pos0.shape)]))
    st = {}
    with torch.no_grad():
        es = energy_batch(qc, pb, st)
        builds = [r["builds"] for r in st["exact_jk"]]
        assert len(set(builds)) > 1
        for m in range(3):
            em = qc.energy_fn(member_params(pb, m))
            assert abs(float(es[m]) - float(em)) <= 1e-10


@pytest.mark.parametrize("orb_param", ["ov", "matexp"])
def test_variational_batch_matches_the_unbatched_solver(orb_param):
    """One BFGS over both members' parameters, the sum of their energies
    from one batched evaluation: each member within 1e-9 Ha of the
    unbatched variational energy at its geometry."""
    opts = dqt.SCFOptions(method="variational", orb_param=orb_param)
    mol = dqt.Mol(WATER, basis="sto-3g", device="cpu")
    qc = dqt.HF(mol, opts=opts)
    pb = _batch(qc)
    st = {}
    with torch.no_grad():
        es = energy_batch(qc, pb, st)
        # one BFGS for the batch, a residual per member
        assert st["var_evaluations"] >= st["iterations"] > 0
        assert len(st["residual"]) == 2
        for m in range(2):
            em = qc.energy_fn(member_params(pb, m))
            assert abs(float(es[m]) - float(em)) <= 1e-9


def test_gamma_batch_position_gradient():
    """d(E_0 + E_1)/d(positions) of a Gamma batch against each member's
    energy_grad at its geometry, 1e-9 relative."""
    qc = port_calc("gamma", None, "aft", dqt.SCFOptions(tol=1e-11))
    pb = _batch(qc)
    x = pb["basis"]["atompos"].clone().requires_grad_(True)
    pb["basis"] = dict(pb["basis"], atompos=x)
    (g,) = torch.autograd.grad(energy_batch(qc, pb).sum(), x)
    ref = torch.stack([qc.energy_grad(member_params(pb, m))["basis"][
        "atompos"] for m in range(2)])
    assert float((g - ref).abs().max()) <= 1e-9 * float(ref.abs().max())


# --- theta, shapes and parameters -------------------------------------------

@pytest.mark.parametrize("system", ["water", "kpt"])
def test_member_at_the_systems_geometry_gets_its_theta(system):
    """The plans are the calc's own: the member at the system's positions
    gets the unbatched theta bit for bit (blocks of the blocked route; a
    k-point cell's Bloch transforms, tables and grid), and the displaced
    member gets the theta the calc builds from its own params, in its own
    slot (the members' thetas differ; the k-point case is the H2 cell,
    whose displaced members are not translates)."""
    qc = (port_calc("water", None, "blocked") if system == "water"
          else port_calc("kpt_h2", "pbe", "aft"))
    p0 = qc._all_params()
    pos = member_positions(p0["basis"]["atompos"].numpy())
    pos[0] = p0["basis"]["atompos"].numpy()
    pb = batch_params(p0, pos)
    with torch.no_grad():
        th_b = pbatch.build_theta_batch(qc, pb)
        ths = [qc._build_theta(p0),
               qc._build_theta(member_params(pb, 1))]

    def check(a, b, m, path):
        if isinstance(b, dict):
            for k in b:
                if k != "xc_params":
                    check(a[k], b[k], m, path + (k,))
        elif isinstance(b, torch.Tensor):
            assert torch.equal(a[m], b), (m, path)
    for m, th in enumerate(ths):
        check(th_b, th, m, ())
    assert not torch.equal(ths[0]["hcore"], ths[1]["hcore"])


def test_a_part_of_another_shape_raises_naming_it():
    th0 = {"grid": {"ao": torch.zeros(4, 2)}, "occ": torch.zeros(2)}
    out = {}
    pbatch._stack_into(out, th0, 0, 2)
    bad = {"grid": {"ao": torch.zeros(5, 2)}, "occ": torch.zeros(2)}
    with pytest.raises(ValueError, match="grid/ao"):
        pbatch._stack_into(out, bad, 1, 2)


def test_batch_params_from_numpy_on_a_sol():
    qc = port_calc("gamma", "lda_x", "aft")
    p0 = qc._all_params()
    pos = member_positions(p0["basis"]["atompos"].numpy())
    pnp = {"basis": {k: (pos if k == "atompos" else
                         [v.numpy() for v in p0["basis"][k]])
                     for k in p0["basis"]},
           "atomzs": p0["atomzs"].numpy()}
    a, b = batch_params(p0, pos), batch_params_from_numpy(pnp, "cpu")
    for m in range(2):
        ma, mb = member_params(a, m), member_params(b, m)
        assert torch.equal(ma["basis"]["atompos"], mb["basis"]["atompos"])
        assert torch.equal(ma["atomzs"], mb["atomzs"])
        for k in ("alphas", "coeffs"):
            for x, y in zip(ma["basis"][k], mb["basis"][k]):
                assert torch.equal(x, y)


# --- K2/K3 on strided member views ------------------------------------------

def _kpoint_tables(nb=2, nk=3, ng=40, m=6, seed=3):
    rng = np.random.default_rng(seed)
    ao = torch.as_tensor(rng.standard_normal((nb, nk, ng, m)))
    ag = torch.as_tensor(rng.standard_normal((nb, nk, 3, ng, m)))
    dm = torch.as_tensor(rng.standard_normal((nb, m, m)))
    vr = torch.as_tensor(rng.standard_normal((nb, ng)))
    vg = torch.as_tensor(rng.standard_normal((nb, 3, ng)))
    return ao, ag, dm, vr, vg


@pytest.mark.parametrize("k", [0, 2])
def test_plain_k2_k3_on_a_strided_member_view(k):
    """The members' tables at k-point k of (B, nk, ng, m) stacks: a view
    whose member stride is nk ng m. The plain K2/K3 on it equal the call
    on a contiguous copy bit for bit."""
    ao, ag, dm, vr, vg = _kpoint_tables()
    a, g = ao[:, k], ag[:, k]
    assert not a.is_contiguous() and a[0].is_contiguous()
    assert a.stride(0) == ao.shape[1] * ao.shape[2] * ao.shape[3]
    ac, gc = a.contiguous(), g.contiguous()
    for x, y in zip(hopper_xc.ds_dens_gga(a, g, dm),
                    hopper_xc.ds_dens_gga(ac, gc, dm)):
        assert torch.equal(x, y)
    assert torch.equal(hopper_xc.ds_vxc_gga(a, g, vr, vg),
                       hopper_xc.ds_vxc_gga(ac, gc, vr, vg))


def test_kernel_layout_takes_member_strides_and_refuses_the_rest():
    """The layouts K2/K3 take on the card (hopper_xc.kernel_layout, checked
    before every launch): a strided member view and a member stride of 0
    for a batch; a view whose members are not contiguous, or an unbatched
    view that is not, raises there."""
    ao = _kpoint_tables()[0]
    assert hopper_xc.kernel_layout(ao[:, 1], True)
    assert hopper_xc.kernel_layout(ao[:1, 1].expand(2, -1, -1), True)
    assert not hopper_xc.kernel_layout(ao[:, 1].transpose(1, 2), True)
    assert not hopper_xc.kernel_layout(ao[0, 1, ::2], False)
    assert hopper_xc.kernel_layout(ao[0, 1], False)


def test_plain_k3_with_a_member_stride_of_zero():
    """Potentials shared by the members (member stride 0, expand) equal
    the explicit copies bit for bit, and so do tables shared the same
    way."""
    ao, ag, _, vr, vg = _kpoint_tables()
    a, g = ao[:, 1], ag[:, 1]
    vr0, vg0 = vr[:1].expand(2, -1), vg[:1].expand(2, -1, -1)
    assert vr0.stride(0) == 0 and vg0.stride(0) == 0
    assert torch.equal(hopper_xc.ds_vxc_gga(a, g, vr0, vg0),
                       hopper_xc.ds_vxc_gga(a, g, vr0.contiguous(),
                                            vg0.contiguous()))
    a0, g0 = a[:1].expand(2, -1, -1), g[:1].expand(2, -1, -1, -1)
    assert torch.equal(hopper_xc.ds_vxc_gga(a0, g0, vr, vg),
                       hopper_xc.ds_vxc_gga(a0.contiguous(), g0.contiguous(),
                                            vr, vg))
