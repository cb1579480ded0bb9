"""PyTorch/CUDA port: XC functionals, the plain versions of the grid kernels
K2/K3 and the XC integration against the JAX package, on the CPU.

Pointwise: every ported functional, value and first derivatives
(torch.autograd against jax.grad) on a rho/sigma sweep from 1e-12 up,
unpolarized and polarized; both sides evaluate the same float64 formulas
with log/exp/pow from different math libraries, so the tolerance is 1e-12
relative to the largest value of each array. Kernels and integration run
on identical tables (convert.grid_theta_from_numpy), so only the order of
float64 sums differs: 1e-10 relative for the kernel contracts (the gate of
the JAX package's own run-time probe) and 1e-11 absolute for energies and
matrices of order 1 to 10. Pallas in interpret mode evaluates its f32 chain
with excess precision; against it the JAX package's own plumbing bound of
1e-5 holds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
from dqc_tpu.ops import pallas_xc
from dqc_tpu.xc import getxc as jgetxc
from dqc_tpu.xc import integrate as jint
from dqc_tpu_torch.convert import grid_theta_from_numpy
from dqc_tpu_torch.ops import hopper_xc
from dqc_tpu_torch.xc import getxc as tgetxc
from dqc_tpu_torch.xc import integrate as tint

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
FUNCTIONALS = ["lda_x", "lda_c_pw", "lda_c_vwn", "lda_c_vwn_rpa", "lda_c_pz",
               "gga_x_pbe", "gga_c_pbe", "gga_x_pbe_sol", "gga_c_pbe_sol",
               "gga_x_pbe_r", "gga_x_rpbe", "gga_x_b88", "gga_c_lyp",
               "gga_x_optx", "b3lyp", "b3lyp5", "pbe", "pbe0", "blyp",
               "svwn", "0.25*hf + 0.75*gga_x_b88 + lda_c_pw"]


def _sweep(polarized):
    """rho from 1e-12 to 1e2 with reduced gradients from tiny to large;
    polarized: spin fractions from nearly empty to full."""
    rng = np.random.default_rng(5)
    rho = 10.0 ** np.linspace(-12, 2, 57)
    s = 10.0 ** rng.uniform(-4, 1, rho.size)          # reduced gradient
    sigma = (s * rho ** (4.0 / 3.0)) ** 2
    if not polarized:
        return {"rho": rho, "sigma": sigma}
    z = rng.uniform(-0.999, 0.999, rho.size)
    ru, rd = 0.5 * rho * (1 + z), 0.5 * rho * (1 - z)
    su = sigma * (0.5 * (1 + z)) ** 2
    sd = sigma * (0.5 * (1 - z)) ** 2
    sud = np.sqrt(su * sd) * rng.uniform(-1, 1, rho.size)
    return {"rho_u": ru, "rho_d": rd, "sigma_uu": su, "sigma_ud": sud,
            "sigma_dd": sd}


def _call(xc, args, polarized):
    keys = list(args)
    if polarized:
        kw = {k: args[k] for k in keys[2:]} if xc.family >= 2 else {}
        return xc.edens_pol(args[keys[0]], args[keys[1]], **kw)
    kw = {"sigma": args["sigma"]} if xc.family >= 2 else {}
    return xc.edens_unpol(args["rho"], **kw)


def _close(t, j, rel):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = np.abs(j).max()
    assert np.abs(t - j).max() <= rel * scale or scale == np.abs(t).max() \
        == 0, np.abs(t - j).max() / scale


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_edens_and_derivatives_match_jax(name, polarized):
    jxc, txc = jgetxc.get_xc(name), tgetxc.get_xc(name)
    assert (txc.family, txc.exx_fraction) == (jxc.family, jxc.exx_fraction)
    args = _sweep(polarized)
    keys = list(args) if txc.family >= 2 else list(args)[:1 + polarized]
    args = {k: args[k] for k in keys}
    tin = {k: torch.tensor(v, requires_grad=True) for k, v in args.items()}
    te = _call(txc, tin, polarized)
    tg = torch.autograd.grad(te.sum(), list(tin.values()), allow_unused=True)
    tg = [torch.zeros_like(x) if g is None else g
          for x, g in zip(tin.values(), tg)]

    def jsum(*vals):
        return jnp.sum(_call(jxc, dict(zip(keys, vals)), polarized))
    jvals = [jnp.asarray(v) for v in args.values()]
    je = _call(jxc, dict(zip(keys, jvals)), polarized)
    jg = jax.grad(jsum, argnums=tuple(range(len(keys))))(*jvals)
    _close(te, je, 1e-12)
    for k, a, b in zip(keys, tg, jg):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("name", ["b3lyp", "pbe", "lda_x"])
@pytest.mark.parametrize("polarized", [False, True])
def test_screened_energy_density_matches_jax(name, polarized):
    """_edens_at with densities on both sides of the 1e-12 screen: values
    and derivatives (zero, never NaN, below it)."""
    rng = np.random.default_rng(9)
    rho = np.concatenate([[0.0, 1e-13, 1e-12, 1.0000001e-12, 2e-12],
                          10.0 ** rng.uniform(-11, 1, 11)])
    grad = rng.standard_normal((3, rho.size)) * rho ** (4.0 / 3.0)
    if polarized:
        dens = {"u": {"rho": 0.6 * rho, "grad": 0.6 * grad},
                "d": {"rho": 0.4 * rho, "grad": 0.4 * grad}}
    else:
        dens = {"rho": rho, "grad": grad}
    jxc, txc = jgetxc.get_xc(name), tgetxc.get_xc(name)
    jd = jax.tree_util.tree_map(jnp.asarray, dens)
    je, jg = jax.value_and_grad(
        lambda d: jnp.sum(jint._edens_at(jxc, d, polarized)))(jd)
    td = jax.tree_util.tree_map(
        lambda v: torch.tensor(np.asarray(v), requires_grad=True), dens)
    leaves = jax.tree_util.tree_leaves(td)
    te = torch.sum(tint._edens_at(txc, td, polarized))
    tg = torch.autograd.grad(te, leaves, allow_unused=True)
    tg = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, tg)]
    _close(te, je, 1e-12)
    for a, b in zip(tg, jax.tree_util.tree_leaves(jg)):
        assert torch.isfinite(a).all()
        _close(a, b, 1e-12)


def test_meta_gga_and_range_separated_names_resolve():
    """The names that needed the meta-GGA and range-separated pieces
    resolve as in the JAX package; unknown and empty names still raise."""
    for name in ("scan", "tpss", "camb3lyp", "lc-blyp", "lr_hf(0.3)",
                 "mgga_x_scan", "0.5*lda_x_erf(0.3) + lda_c_pw"):
        t, j = tgetxc.get_xc(name), jgetxc.get_xc(name)
        assert (t.family, t.exx_fraction, t.exx_lr) == \
            (j.family, j.exx_fraction, j.exx_lr)
    with pytest.raises(NotImplementedError):
        tgetxc.get_xc("no_such_functional")
    with pytest.raises(ValueError):
        tgetxc.get_xc(" ")


# --- the plain versions of K2 and K3 ----------------------------------------

def _tables(ng, nao, seed):
    rng = np.random.default_rng(seed)
    ao = rng.standard_normal((ng, nao)) * np.exp(rng.uniform(-6, 2, (ng, nao)))
    ag = rng.standard_normal((3, ng, nao)) * np.exp(
        rng.uniform(-6, 2, (3, ng, nao)))
    return ao, ag


@pytest.mark.parametrize(
    "ng,nao,symmetric",
    [(100, 10, True), (700, 26, True), (100, 10, False), (700, 26, False)],
    ids=["100-10", "700-26", "100-10-nonsym", "700-26-nonsym"])
def test_dens_plain_version_matches_jax(ng, nao, symmetric):
    """The one-GEMM plain version (c = ao @ dm.T, then row dots) against
    the JAX package's four-contraction oracle, also for a dm that is not
    symmetric."""
    ao, ag = _tables(ng, nao, seed=3)
    rng = np.random.default_rng(4)
    dm = rng.standard_normal((nao, nao))
    if symmetric:
        dm = dm + dm.T
    rho, gdot = hopper_xc.ds_dens_gga(torch.as_tensor(ao),
                                      torch.as_tensor(ag), torch.as_tensor(dm))
    planes = pallas_xc.grid_planes(jnp.asarray(ao), jnp.asarray(ag))
    jr, jgd = pallas_xc.ds_dens_reference(planes, jnp.asarray(dm), ng)
    # the planes hold each table to 2^-46 relative: the f64 oracle on them
    _close(rho, jr, 1e-10)
    _close(gdot, jgd, 1e-10)
    kr, kg = pallas_xc.ds_dens_gga(planes, jnp.asarray(dm), ng,
                                   interpret=True)
    _close(rho, kr, 1e-5)
    _close(gdot, kg, 1e-5)


@pytest.mark.parametrize("nao", [1, 7, 114, 150, 300, 512])
def test_dens_plan_fits_the_card(nao):
    """The launch plan of K2 stays inside a block's shared memory, its
    panels cover nao exactly, and it launches at least one block."""
    ng = 78144 if nao == 114 else 1000
    plan = hopper_xc.dens_plan(ng, nao)
    assert 0 < plan["smem_bytes"] <= 232_448
    w = plan["panel"]
    assert w % 8 == 0 and 0 < w <= 128
    widths = [min(w, nao - p * w) for p in range(plan["panels"])]
    assert all(x > 0 for x in widths) and sum(widths) == nao
    stage = hopper_xc.dens_stage_doubles(w, nao)
    assert plan["smem_bytes"] == 8 * (plan["stages"] * stage
                                      + hopper_xc.D_RED_DOUBLES)
    assert plan["stages"] in (2, 3)
    if plan["stages"] == 2:   # three stages only where they do not fit
        assert 8 * (3 * stage + hopper_xc.D_RED_DOUBLES) > 232_448
    assert 1 <= plan["blocks"] <= min(132, plan["tiles"])
    assert plan["tiles"] * plan["tile_points"] >= ng
    assert hopper_xc.dens_plan(1, nao)["blocks"] == 1
    if nao <= 128:       # one panel: dm loaded once a block, each table read once
        assert plan["panels"] == 1 and w >= nao


@pytest.mark.parametrize("ng,nao", [(0, 7), (10, 0), (-1, 5)])
def test_dens_plan_refuses_empty_shapes(ng, nao):
    with pytest.raises(ValueError, match="must be > 0"):
        hopper_xc.dens_plan(ng, nao)


@pytest.mark.parametrize("ng,nao", [(100, 10), (700, 26)])
def test_vxc_plain_version_matches_jax(ng, nao):
    ao, ag = _tables(ng, nao, seed=5)
    rng = np.random.default_rng(6)
    vr, vg = rng.standard_normal(ng), rng.standard_normal((3, ng))
    v = hopper_xc.ds_vxc_gga(*(torch.as_tensor(x) for x in (ao, ag, vr, vg)))
    asm = jint._vxc_assemble({"rho": jnp.asarray(vr), "grad": jnp.asarray(vg)},
                             {"ao": jnp.asarray(ao), "ao_grad": jnp.asarray(ag)})
    _close(v, asm, 1e-10)
    planes = pallas_xc.grid_planes(jnp.asarray(ao), jnp.asarray(ag))
    wth, wtl = pallas_xc.build_wt(planes, jnp.asarray(vr), jnp.asarray(vg), ng)
    _close(v, pallas_xc.ds_vxc_reference(planes, wth, wtl)[:nao, :nao], 1e-10)
    _close(v, pallas_xc.ds_vxc_gga(planes, wth, wtl, nao, interpret=True),
           1e-5)


@pytest.mark.parametrize("nao", [1, 7, 114, 150, 215, 300])
def test_vxc_plan_fits_the_card(nao):
    """The launch plan of K3 stays inside a block's shared memory, its
    sub-blocks cover V exactly (one for nao <= 128, so each table is read
    once), and it launches between one block and one per multiprocessor."""
    ng = 78144 if nao == 114 else 1000
    plan = hopper_xc.vxc_plan(ng, nao)
    assert 0 < plan["smem_bytes"] <= 232_448
    w, n = plan["panel"], plan["panels"]
    assert w % 16 == 0 and 0 < w <= 128
    widths = [min(w, nao - p * w) for p in range(n)]
    assert all(x > 0 for x in widths) and sum(widths) == nao
    assert plan["sub_blocks"] == n * n
    assert plan["smem_bytes"] == hopper_xc.vxc_smem_bytes(nao, w, n,
                                                          plan["stages"])
    assert plan["stages"] in (2, 3)
    if plan["stages"] == 2:   # three stages only where they do not fit
        assert hopper_xc.vxc_smem_bytes(nao, w, n, 3) > 232_448
    assert 1 <= plan["blocks"] <= min(132, plan["tiles"])
    assert plan["tiles"] * plan["tile_points"] >= ng
    assert (plan["tiles"] - 1) * plan["tile_points"] < ng
    assert hopper_xc.vxc_plan(1, nao)["blocks"] == 1
    if nao <= 128:
        assert n == 1 and w >= nao


@pytest.mark.parametrize("ng,nao,sms", [(0, 7, 132), (10, 0, 132),
                                        (-1, 5, 132), (10, 5, 0)])
def test_vxc_plan_refuses_empty_shapes(ng, nao, sms):
    with pytest.raises(ValueError, match="must be > 0"):
        hopper_xc.vxc_plan(ng, nao, sms)


def _vxc_replay(ao, ag, vr, vg, plan):
    """The kernel's partition in torch: block b sums its tiles
    [b * tiles // blocks, (b + 1) * tiles // blocks) in order into one
    partial V per sub-block of the plan's panels, WT formed per tile; then
    the fold: the partials of V_FOLD_GROUPS groups of consecutive blocks,
    each in block order, then the group sums in order."""
    ng, nao = ao.shape
    t, blocks, w = plan["tile_points"], plan["blocks"], plan["panel"]
    tiles = plan["tiles"]
    part = torch.full((blocks, nao, nao), float("nan"), dtype=ao.dtype)
    for b in range(blocks):
        t0, t1 = b * tiles // blocks, (b + 1) * tiles // blocks
        assert t1 > t0                     # no block without a tile
        for p in range(plan["panels"]):
            ip = slice(p * w, min(nao, (p + 1) * w))
            for q in range(plan["panels"]):
                jq = slice(q * w, min(nao, (q + 1) * w))
                assert torch.isnan(part[b, ip, jq]).all()   # written once
                acc = torch.zeros((ip.stop - ip.start, jq.stop - jq.start),
                                  dtype=ao.dtype)
                for tile in range(t0, t1):
                    g = slice(tile * t, min(ng, (tile + 1) * t))
                    wt = vr[g, None] * ao[g, ip] + 2.0 * torch.einsum(
                        "dg,dgi->gi", vg[:, g], ag[:, g, ip])
                    acc += wt.T @ ao[g, jq]
                part[b, ip, jq] = acc
    assert not torch.isnan(part).any()     # every partial fully written
    per = -(-blocks // hopper_xc.V_FOLD_GROUPS)
    sums = []
    for g in range(hopper_xc.V_FOLD_GROUPS):
        s = torch.zeros((nao, nao), dtype=ao.dtype)
        for b in range(g * per, min(blocks, (g + 1) * per)):
            s += part[b]
        sums.append(s)
    v = sums[0]
    for s in sums[1:]:
        v = v + s
    return v


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("ng,nao", [(100, 10), (33, 7), (700, 150)])
def test_vxc_plan_replay_matches_reference(ng, nao, sms):
    """Partial V per block and sub-block, folded in the fixed order of the
    kernel's second pass, give the plain version and the JAX package's
    assembly: the plan's partition loses and repeats nothing."""
    ao, ag = _tables(ng, nao, seed=ng + 7)
    rng = np.random.default_rng(nao + 7)
    vr, vg = rng.standard_normal(ng), rng.standard_normal((3, ng))
    tt = [torch.as_tensor(x) for x in (ao, ag, vr, vg)]
    v = _vxc_replay(*tt, hopper_xc.vxc_plan(ng, nao, sms))
    _close(v, hopper_xc.ds_vxc_reference(*tt).numpy(), 1e-12)
    asm = jint._vxc_assemble(
        {"rho": jnp.asarray(vr), "grad": jnp.asarray(vg)},
        {"ao": jnp.asarray(ao), "ao_grad": jnp.asarray(ag)})
    _close(v, asm, 1e-10)


def test_plain_versions_pass_autograd_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions, which autograd
    differentiates (on the card the kernels' own backward does); bad
    dtypes and shapes raise on either device."""
    ao, ag = (torch.as_tensor(x) for x in _tables(20, 4, seed=1))
    rng = np.random.default_rng(2)
    dm = torch.tensor(rng.standard_normal((4, 4)), requires_grad=True)
    w = torch.as_tensor(rng.standard_normal(20))
    rho, gdot = hopper_xc.ds_dens_gga(ao, ag, dm)
    (g,) = torch.autograd.grad(torch.sum(w * rho) + gdot.sum(), dm)
    # d/d dm_ij of sum_g w_g rho_g + sum_dg gdot_dg, in closed form
    ref = torch.einsum("gi,g,gj->ij", ao, w, ao) \
        + 2.0 * torch.einsum("dgi,gj->ij", ag, ao)
    _close(g, ref.numpy(), 1e-12)
    vr = w.clone().requires_grad_(True)
    v = hopper_xc.ds_vxc_gga(ao, ag, vr, torch.ones((3, 20),
                                                    dtype=torch.float64))
    (gv,) = torch.autograd.grad(v.sum(), vr)
    _close(gv, (ao.sum(1) ** 2).numpy(), 1e-12)
    with pytest.raises(TypeError):
        hopper_xc.ds_dens_gga(ao.float(), ag.float(), dm.detach().float())
    with pytest.raises(ValueError):
        hopper_xc.ds_vxc_gga(ao, ag, torch.ones(3, dtype=torch.float64),
                             torch.ones((3, 20), dtype=torch.float64))


# --- integration on identical tables ----------------------------------------

@functools.lru_cache(maxsize=None)
def _grid(family):
    """JAX grid theta of H2O/3-21G, grid level 1 (6,604 points, nao = 13),
    and the port's copy of the same numbers."""
    m = dqc_tpu.Mol(H2O, basis="3-21G", grid=1)
    jt = jint.setup_grid_theta(m.meta, m.params, m.setup_grid(), family=family)
    tt = grid_theta_from_numpy(
        np.asarray(jt["coords"]), np.asarray(jt["dvol"]), np.asarray(jt["ao"]),
        None if family < 2 else np.asarray(jt["ao_grad"]), family=family,
        device="cpu")
    return jt, tt


def _dm(polarized, nao=13):
    rng = np.random.default_rng(21)
    a = rng.standard_normal((nao, nao)) * 0.1
    d = a @ a.T + 0.05 * np.eye(nao)
    return np.stack([0.6 * d, 0.4 * d]) if polarized else d


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("name", ["b3lyp", "pbe", "svwn"])
def test_exc_vxc_matches_jax(name, polarized):
    jxc, txc = jgetxc.get_xc(name), tgetxc.get_xc(name)
    jt, tt = _grid(jxc.family)
    dm = _dm(polarized)
    je, jv = jint.exc_vxc(jxc, jnp.asarray(dm), jt, polarized)
    te, tv = tint.exc_vxc(txc, torch.as_tensor(dm), tt, polarized)
    assert abs(float(te) - float(je)) <= 1e-11
    _close(tv, jv, 1e-11)
    # the energy alone, the symmetrised matrix, and the autograd oracle
    e2 = tint.exc_energy(txc, torch.as_tensor(dm), tt, polarized)
    assert abs(float(e2) - float(jint.exc_energy(jxc, jnp.asarray(dm), jt,
                                                 polarized))) <= 1e-11
    vm = tint.vxc_matrix(txc, torch.as_tensor(dm), tt, polarized)
    assert torch.equal(vm, tv)
    vad = tint.vxc_matrix_ad(txc, torch.as_tensor(dm), tt, polarized)
    _close(vad, jint.vxc_matrix_ad(jxc, jnp.asarray(dm), jt, polarized), 1e-11)
    _close(vad, tv, 1e-11)


@pytest.mark.parametrize("polarized", [False, True])
def test_chunked_grid_gives_the_unchunked_result(polarized):
    """On the CPU, beyond XC_CHUNK_ELEMS, the grid axis is cut into chunks
    (map_reduce_blocks); the sums agree with the unchunked ones."""
    _, tt = _grid(2)
    txc = tgetxc.get_xc("b3lyp")
    dm = torch.as_tensor(_dm(polarized))
    e0, v0 = tint.exc_vxc(txc, dm, tt, polarized)
    e1, v1 = tint.exc_vxc(txc, dm, tt, polarized, chunk=1000)
    e2 = tint.exc_energy(txc, dm, tt, polarized, chunk=1000)
    assert abs(float(e1) - float(e0)) <= 1e-12
    assert abs(float(e2) - float(e0)) <= 1e-12
    _close(v1, v0, 1e-12)


def test_kernel_route_is_taken_for_a_gga_only(monkeypatch):
    """A GGA goes through the K2/K3 wrappers (their plain versions on the
    CPU), once per chunk of the grid and also when differentiated; an LDA
    does not."""
    calls = {"dens": 0, "vxc": 0}

    def spy(name):
        real = getattr(hopper_xc, name)

        def f(*a):
            calls[name.split("_")[1]] += 1
            return real(*a)
        return f
    monkeypatch.setattr(hopper_xc, "ds_dens_gga", spy("ds_dens_gga"))
    monkeypatch.setattr(hopper_xc, "ds_vxc_gga", spy("ds_vxc_gga"))
    _, tt = _grid(2)
    ng = tt["dvol"].shape[0]
    dm = torch.as_tensor(_dm(False))
    tint.exc_vxc(tgetxc.get_xc("pbe"), dm, tt, False)
    assert calls == {"dens": 1, "vxc": 1}
    tint.exc_vxc(tgetxc.get_xc("pbe"), dm, tt, False, chunk=1000)
    assert calls == {"dens": 1 + -(-ng // 1000), "vxc": 1 + -(-ng // 1000)}
    tint.vxc_matrix_ad(tgetxc.get_xc("pbe"), dm, tt, False)
    assert calls["dens"] == 2 + -(-ng // 1000)
    _, tt1 = _grid(1)
    before = dict(calls)
    tint.exc_vxc(tgetxc.get_xc("lda_x"), dm, tt1, False)
    assert calls == before
