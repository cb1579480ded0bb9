"""PyTorch/CUDA port: the batch axis (parallel/batch.py) against the JAX
package's jax.vmap of its energy_fn, on the CPU.

- The kernels' plain versions with a leading batch axis, against a loop
  over the members: bitwise (the plain version is taken member by member,
  so each member keeps the bits of its unbatched call), and their
  backward; the launch plans of a batch, and K1's batched partition
  replayed in torch (every tile of every member folded in the kernel's
  order) against the plain version, 1e-12 relative.
- energy_batch on H2/STO-3G grid 0 at five distances with a neural
  CustomXC of family 1 and of family 2 (the setups of tests/test_nnxc.py
  and tests/test_parallel.py): the energies against jax.vmap(qc.energy_fn)
  within 1e-10 Ha, and the MSE loss and its gradient in the NN parameters
  against jax.value_and_grad within 1e-12 and 1e-8 relative (the two
  packages converge their SCFs to 1e-8 in the commutator, the energy to
  second order in it).
- A polarized batch (H3 chains, UKS-LDA) with the position gradient of
  the summed energies against jax.grad of the vmapped sum, 1e-8 relative.
- The batch against the port's own unbatched energy_fn member by member on
  the DF route and with a hybrid (every other route:
  tests/test_torch_batch_routes.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu.xc.custom import CustomXC as JCustomXC
from dqc_tpu_torch.convert import batch_params_from_numpy, xc_params_from_numpy
from dqc_tpu_torch.ops import hopper_jk, hopper_xc
from dqc_tpu_torch.parallel.batch import energy_batch
from dqc_tpu_torch.utils.datastruct import (batch_params, batch_size,
                                            member_params)
from dqc_tpu_torch.xc.custom import CustomXC

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2 = "H -0.5 0 0; H 0.5 0 0"
CX = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)
DISTS = np.linspace(0.9, 1.5, 5)


def _rng_sym(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x + np.swapaxes(x, -1, -2)


def _eri_like(nb, n, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((nb, n, n, n, n))
    t = t + t.transpose(0, 2, 1, 3, 4)
    t = t + t.transpose(0, 1, 2, 4, 3)
    return t + t.transpose(0, 3, 4, 1, 2)


# --- the kernels' plain versions with a batch axis --------------------------

def test_plain_k1_k2_k3_batched_equal_the_member_loop_bitwise():
    nb, n, ng = 3, 6, 40
    T = torch.as_tensor(_eri_like(nb, n, 1))
    dm = torch.as_tensor(_rng_sym((nb, n, n), 2))
    rng = np.random.default_rng(3)
    ao = torch.as_tensor(rng.standard_normal((nb, ng, n)))
    ag = torch.as_tensor(rng.standard_normal((nb, 3, ng, n)))
    vr = torch.as_tensor(rng.standard_normal((nb, ng)))
    vg = torch.as_tensor(rng.standard_normal((nb, 3, ng)))
    trail, mid = hopper_jk.ds_jk(T, dm)
    rho, gdot = hopper_xc.ds_dens_gga(ao, ag, dm)
    v = hopper_xc.ds_vxc_gga(ao, ag, vr, vg)
    assert trail.shape == (nb, n, n) and v.shape == (nb, n, n)
    assert rho.shape == (nb, ng) and gdot.shape == (nb, 3, ng)
    for m in range(nb):
        t1, m1 = hopper_jk.ds_jk(T[m], dm[m])
        r1, g1 = hopper_xc.ds_dens_gga(ao[m], ag[m], dm[m])
        assert torch.equal(trail[m], t1) and torch.equal(mid[m], m1)
        assert torch.equal(rho[m], r1) and torch.equal(gdot[m], g1)
        assert torch.equal(v[m], hopper_xc.ds_vxc_gga(ao[m], ag[m], vr[m],
                                                      vg[m]))


def test_batched_backward_equals_the_member_loop():
    """The Functions' backward with a batch axis: the cotangents of dm,
    the tables and the potentials, member by member, 1e-13."""
    nb, n, ng = 2, 5, 30
    rng = np.random.default_rng(5)

    def leaf(x):
        return torch.as_tensor(x).requires_grad_(True)
    T = leaf(_eri_like(nb, n, 4))
    dm, ao = leaf(_rng_sym((nb, n, n), 6)), leaf(rng.standard_normal(
        (nb, ng, n)))
    ag = leaf(rng.standard_normal((nb, 3, ng, n)))
    vr, vg = leaf(rng.standard_normal((nb, ng))), leaf(
        rng.standard_normal((nb, 3, ng)))
    ins = (T, dm, ao, ag, vr, vg)

    def loss(T, dm, ao, ag, vr, vg):
        k, j = hopper_jk.ds_jk(T, dm)
        rho, gd = hopper_xc.ds_dens_gga(ao, ag, dm)
        v = hopper_xc.ds_vxc_gga(ao, ag, vr, vg)
        return ((k * j).sum() + (rho ** 2).sum() + (gd * rho[..., None, :])
                .sum() + (v * dm).sum())
    g_b = torch.autograd.grad(loss(*ins), ins)
    for m in range(nb):
        g_m = torch.autograd.grad(loss(*(x[m:m + 1] for x in ins)), ins)
        for a, b in zip(g_b, g_m):
            np.testing.assert_allclose(a[m].detach().numpy(),
                                       b[m].detach().numpy(), rtol=1e-13,
                                       atol=1e-13 * float(a.abs().max()))


@pytest.mark.parametrize("nb", [1, 3, 8])
def test_batched_plans_fit_the_card(nb):
    """B x the work over the card's 132 multiprocessors: K1's blocks walk
    the batch's B n^2 tiles; K2 and K3 take sms // B blocks per member
    (the grid's y axis the member); B = 1 is the unbatched plan."""
    n, ng = 114, 78144
    p = hopper_jk.jk_plan(n, 132, nb)
    assert p["blocks"] <= 132 and p["blocks"] * p["tiles_per_block"] >= \
        nb * n * n
    if nb == 1:
        assert p == hopper_jk.jk_plan(n, 132)
        assert hopper_xc.dens_plan(ng, n, 132, 1) == dict(
            hopper_xc.dens_plan(ng, n, 132), batch=1)
    d = hopper_xc.dens_plan(ng, n, 132, nb)
    v = hopper_xc.vxc_plan(ng, n, 132, nb)
    assert d["blocks"] == v["blocks"] == 132 // nb
    assert d["blocks"] * nb <= 132 and v["blocks"] * nb <= 132


def _replay_batch(T, dm, plan):
    """K1's partition of a batch in torch: the global tile t = (m n + i) n
    + a, each block's range in order (a range may cross members), K per
    tile as one slot per warp, J per row (m, i) as one slot per block; the
    fold in index order."""
    nb, n = dm.shape[0], dm.shape[-1]
    w = hopper_jk.JK_WARPS
    tpb, islots = plan["tiles_per_block"], plan["islots"]
    tiles = T.reshape(nb * n * n, n, n)
    rows = nb * n
    k_part = torch.zeros((nb * n * n, w), dtype=T.dtype)
    mid_part = torch.full((plan["blocks"], islots, n), float("nan"),
                          dtype=T.dtype)
    rows_of = [torch.tensor(range(wp, n, w), dtype=torch.long)
               for wp in range(w)]
    for q in range(plan["blocks"]):
        t0, t1 = q * tpb, min((q + 1) * tpb, nb * n * n)
        jacc = torch.zeros(n, dtype=T.dtype)
        for tt in range(t0, t1):
            gi, a = divmod(tt, n)
            d = dm[tt // (n * n)]
            prod = tiles[tt] * d
            for wp in range(w):
                k_part[tt, wp] = prod[rows_of[wp]].sum()
            jacc += tiles[tt] @ d[a]
            if a == n - 1 or tt == t1 - 1:
                mid_part[q, gi - t0 // n] = jacc
                jacc = torch.zeros(n, dtype=T.dtype)
    trail = k_part.sum(-1).reshape(nb, n, n)
    mid = torch.zeros((rows, n), dtype=T.dtype)
    for gi in range(rows):
        for q in range(gi * n // tpb, ((gi + 1) * n - 1) // tpb + 1):
            mid[gi] += mid_part[q, gi - q * tpb // n]
    assert not torch.isnan(mid).any()
    return trail, mid.reshape(nb, n, n)


@pytest.mark.parametrize("nb,n,sms", [(3, 7, 5), (2, 10, 132), (4, 5, 3)])
def test_batched_k1_partition_replay_matches_reference(nb, n, sms):
    T = torch.as_tensor(_eri_like(nb, n, n))
    dm = torch.as_tensor(np.random.default_rng(n).standard_normal(
        (nb, n, n)))
    trail, mid = _replay_batch(T, dm, hopper_jk.jk_plan(n, sms, nb))
    rt, rm = hopper_jk.ds_jk_reference(T, dm)
    for a, r in ((trail, rt), (mid, rm)):
        assert float((a - r).abs().max() / r.abs().max()) <= 1e-12


# --- energy_batch against jax.vmap of the JAX package's energy_fn ----------

def _nn(xp, p, rho, sigma=None):
    """-Cx rho^(4/3) (1 + 0.2 tanh(NN(rho^(1/3)[, s]))) in jnp or torch."""
    n43 = rho ** (4.0 / 3.0)
    h = rho[..., None] ** (1.0 / 3.0) * p["w1"] + p["b1"]
    if sigma is not None:
        s = xp.sqrt(xp.maximum(sigma, 1e-40 + 0 * sigma)) / n43
        h = h + s[..., None] * p["ws"]
    f = 1.0 + 0.2 * xp.tanh(xp.tanh(h) @ p["w2"] + p["b2"])[..., 0]
    return -CX * n43 * f


def _nn_params(seed=3):
    rng = np.random.default_rng(seed)
    return {"w1": 0.5 * rng.standard_normal(4),
            "ws": 0.5 * rng.standard_normal(4),
            "b1": 0.1 * rng.standard_normal(4),
            "w2": 0.5 * rng.standard_normal((4, 1)),
            "b2": 0.1 * rng.standard_normal(1)}


@pytest.mark.parametrize("family", [1, 2])
def test_nnxc_batch_matches_jax_vmap_and_value_and_grad(family):
    pnp = _nn_params()
    pos = np.stack([[[-d / 2, 0, 0], [d / 2, 0, 0]] for d in DISTS])
    targets = -1.05 - 0.05 * np.cos(DISTS)

    def fn(xp):
        if family == 1:
            return lambda p, d: _nn(xp, p, d["rho"])
        return lambda p, d: _nn(xp, p, d["rho"], d["sigma"])

    # the JAX package: jax.vmap of energy_fn, value_and_grad of the loss
    jxc = JCustomXC(fn(jnp), {k: jnp.asarray(v) for k, v in pnp.items()},
                    family=family, key="nn")
    jqc = dqc_tpu.KS(dqc_tpu.Mol(H2, basis="sto-3g", grid=0), xc=jxc)
    jp0 = jqc._all_params()

    def loss(xcp):
        def one(p_):
            p = dict(jp0, xc_params=xcp)
            p["basis"] = dict(jp0["basis"], atompos=p_)
            return jqc.energy_fn(p)
        es = jax.vmap(one)(jnp.asarray(pos))
        return jnp.mean((es - jnp.asarray(targets)) ** 2), es
    (jl, jes), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {"nn": {k: jnp.asarray(v) for k, v in pnp.items()}})

    # the port: energy_batch of a batched params tree
    tp = xc_params_from_numpy(pnp, "cpu")
    txc = CustomXC(fn(torch), tp, family=family, key="nn")
    tqc = dqt.KS(dqt.Mol(H2, basis="sto-3g", grid=0, device="cpu"), xc=txc)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    pb = batch_params(tqc._all_params(), pos)
    pb["xc_params"] = {"nn": leaves}
    st = {}
    es = energy_batch(tqc, pb, st)
    tl = torch.mean((es - torch.as_tensor(targets)) ** 2)
    # family 1 has no gradient input: its "ws" is unused on both sides
    tg = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True)

    assert batch_size(pb) == len(DISTS) and st["batch"] == len(DISTS)
    assert len(st["iterations"]) == len(DISTS)
    np.testing.assert_allclose(es.detach().numpy(), np.asarray(jes),
                               rtol=0, atol=1e-10)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-12
    for k, g in zip(leaves, tg):
        ref = np.asarray(jg["nn"][k])
        got = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-8,
                                   atol=1e-8 * max(np.abs(ref).max(), 1e-30))


def test_batch_params_from_numpy_matches_batch_params():
    qc = dqt.HF(dqt.Mol(H2, basis="sto-3g", device="cpu"))
    p0 = qc._all_params()
    pos = np.stack([[[-d / 2, 0, 0], [d / 2, 0, 0]] for d in DISTS[:2]])
    pb = batch_params(p0, pos)
    pnp = {"basis": {k: (pos if k == "atompos" else
                         [v.numpy() for v in p0["basis"][k]])
                     for k in p0["basis"]},
           "atomzs": p0["atomzs"].numpy()}
    pc = batch_params_from_numpy(pnp, "cpu")
    for m in range(2):
        a, b = member_params(pb, m), member_params(pc, m)
        assert torch.equal(a["basis"]["atompos"], b["basis"]["atompos"])
        assert torch.equal(a["atomzs"], b["atomzs"])
        for x, y in zip(a["basis"]["alphas"], b["basis"]["alphas"]):
            assert torch.equal(x, y)


def test_polarized_batch_and_positions_match_jax():
    """UKS-LDA of two H3 chains (doublets): energies within 1e-10 Ha of
    jax.vmap(energy_fn), the position gradient of their sum within 1e-8
    relative of jax.grad of the vmapped sum. Both SCFs at tol 1e-11: at
    the default 1e-8 each package's gradient carries its own residual
    (4e-9 apart here)."""
    desc = "H -1.4 0 0; H 0 0 0; H 1.5 0 0"
    pos0 = np.array([[-1.4, 0, 0], [0, 0, 0], [1.5, 0, 0]])
    pos = np.stack([pos0, pos0 + np.array([[0.1, 0.05, 0], [0, 0, 0],
                                           [-0.05, 0, 0.1]])])
    jqc = dqc_tpu.KS(dqc_tpu.Mol(desc, basis="sto-3g", grid=0),
                     xc="lda_x", opts=JOptions(tol=1e-11))
    jp0 = jqc._all_params()

    def esum(p_):
        def one(q):
            p = dict(jp0)
            p["basis"] = dict(jp0["basis"], atompos=q)
            return jqc.energy_fn(p)
        es = jax.vmap(one)(p_)
        return es.sum(), es
    (_, jes), jg = jax.jit(jax.value_and_grad(esum, has_aux=True))(
        jnp.asarray(pos))

    tqc = dqt.KS(dqt.Mol(desc, basis="sto-3g", grid=0, device="cpu"),
                 xc="lda_x", opts=dqt.SCFOptions(tol=1e-11))
    assert tqc.engine.polarized
    pb = batch_params(tqc._all_params(), pos)
    x = pb["basis"]["atompos"].clone().requires_grad_(True)
    pb["basis"] = dict(pb["basis"], atompos=x)
    es = energy_batch(tqc, pb)
    (g,) = torch.autograd.grad(es.sum(), x)
    np.testing.assert_allclose(es.detach().numpy(), np.asarray(jes),
                               rtol=0, atol=1e-10)
    ref = np.asarray(jg)
    np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                               atol=1e-8 * np.abs(ref).max())


# --- the port's batch against its own unbatched energy_fn ------------------

@pytest.mark.parametrize("route", ["dense_b3lyp", "df_pbe"])
def test_batch_equals_the_members_energy_fn(route):
    """A hybrid on the dense route and a GGA on the DF route: each member
    of the batch within 1e-11 Ha of the unbatched energy_fn at its
    geometry (the same SCF, member by member)."""
    desc = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
    mol = dqt.Mol(desc, basis="sto-3g", grid=0, device="cpu")
    if route == "df_pbe":
        mol.densityfit()
    qc = dqt.KS(mol, xc="b3lyp" if route == "dense_b3lyp" else "pbe")
    p0 = qc._all_params()
    rng = np.random.default_rng(11)
    pos = p0["basis"]["atompos"].numpy() + 0.05 * rng.standard_normal(
        (2, 3, 3))
    pb = batch_params(p0, pos)
    with torch.no_grad():
        es = energy_batch(qc, pb)
        for m in range(2):
            em = qc.energy_fn(member_params(pb, m))
            assert abs(float(es[m]) - float(em)) <= 1e-11
