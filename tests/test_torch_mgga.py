"""PyTorch/CUDA port: meta-GGA functionals (SCAN, TPSS and their hybrids)
against the JAX package, on the CPU.

Pointwise: value and first derivatives in rho, sigma, lapl and tau against
jax.grad on a sweep from 1e-12 up whose tau runs from the von Weizsaecker
bound tau_W (alpha = 0) through alpha = 1 (the switch of SCAN's
interpolation) to alpha = 5, to 1e-12 relative to the largest value of each
array; through the double-where screen of _edens_at as well, with points
below the 1e-12 threshold (zero, never NaN).

SCF: SCAN on H2O/3-21G grid 1: the converged energies of the two packages
within 1e-10 Ha; on the JAX package's theta (ao_lapl among the grid
tables) the port's Fock matrix and energy at the JAX density to 1e-11, and
the derivative of the Fock matrix in dm along a seeded direction against
jax.jvp to 1e-9 (the family-4 route under autograd). Forces of TPSS and SCAN
keep the mirror symmetries of H2O and match central differences.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu.xc import getxc as jgetxc
from dqc_tpu.xc import integrate as jint
from dqc_tpu_torch.convert import grid_theta_from_numpy, theta_from_numpy
from dqc_tpu_torch.scf import engine as tengine
from dqc_tpu_torch.xc import getxc as tgetxc
from dqc_tpu_torch.xc import integrate as tint

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
MGGA = ["mgga_x_scan", "mgga_c_scan", "mgga_x_tpss", "mgga_c_tpss",
        "scan", "tpss", "tpssh", "scan0"]
C_TF = 0.3 * (3.0 * np.pi ** 2) ** (2.0 / 3.0)


def _close(t, j, rel):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = np.abs(j).max()
    err = np.abs(t - j).max()
    assert err <= rel * scale or scale == np.abs(t).max() == 0, err / scale


def _spin_sweep(rng, n):
    rho = 10.0 ** np.linspace(-12, 2, n)
    s = 10.0 ** rng.uniform(-4, 1, n)
    sigma = (s * rho ** (4.0 / 3.0)) ** 2
    # alpha = (tau - tau_W) / tau_unif: 0 (tau = tau_W), exactly 1, and
    # values on both sides of the switch
    alpha = rng.choice([0.0, 1.0, 1.0 - 1e-9, 1.0 + 1e-9, 0.3, 2.5, 5.0],
                       n)
    tau = sigma / (8.0 * rho) + alpha * C_TF * rho ** (5.0 / 3.0)
    lapl = rng.standard_normal(n) * rho
    return rho, sigma, lapl, tau


def _sweep(polarized):
    rng = np.random.default_rng(21)
    n = 57
    if not polarized:
        rho, sigma, lapl, tau = _spin_sweep(rng, n)
        return {"rho": rho, "sigma": sigma, "lapl": lapl, "tau": tau}
    ru, su, lu, tu = _spin_sweep(rng, n)
    rd, sd, ld, td = _spin_sweep(rng, n)
    perm = rng.permutation(n)        # unlike spins on one point
    rd, sd, ld, td = rd[perm], sd[perm], ld[perm], td[perm]
    sud = np.sqrt(su * sd) * rng.uniform(-1, 1, n)
    return {"rho_u": ru, "rho_d": rd, "sigma_uu": su, "sigma_ud": sud,
            "sigma_dd": sd, "lapl_u": lu, "lapl_d": ld, "tau_u": tu,
            "tau_d": td}


def _call(xc, args, polarized):
    if polarized:
        kw = {k: v for k, v in args.items() if k not in ("rho_u", "rho_d")}
        return xc.edens_pol(args["rho_u"], args["rho_d"], **kw)
    return xc.edens_unpol(args["rho"], sigma=args["sigma"],
                          lapl=args["lapl"], tau=args["tau"])


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("name", MGGA)
def test_mgga_edens_and_derivatives_match_jax(name, polarized):
    jxc, txc = jgetxc.get_xc(name), tgetxc.get_xc(name)
    args = _sweep(polarized)
    keys = list(args)
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
    for a, b in zip(tg, jg):
        assert torch.isfinite(a).all()
        _close(a, b, 1e-12)


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("name", ["scan", "tpss"])
def test_mgga_screened_energy_density_matches_jax(name, polarized):
    """_edens_at with lapl and tau, densities on both sides of the 1e-12
    screen: values and derivatives (zero, never NaN, below it)."""
    rng = np.random.default_rng(23)
    rho = np.concatenate([[0.0, 1e-13, 1e-12, 1.0000001e-12, 2e-12],
                          10.0 ** rng.uniform(-11, 1, 11)])
    grad = rng.standard_normal((3, rho.size)) * rho ** (4.0 / 3.0)
    tau = (np.sum(grad ** 2, axis=0) / (8.0 * np.maximum(rho, 1e-30))
           + rng.uniform(0, 3, rho.size) * C_TF * rho ** (5.0 / 3.0))
    lapl = rng.standard_normal(rho.size) * rho

    def one(f):
        return {"rho": f * rho, "grad": f * grad, "lapl": f * lapl,
                "tau": f * tau}
    dens = {"u": one(0.6), "d": one(0.4)} if polarized else one(1.0)
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


@pytest.mark.parametrize("name", MGGA)
def test_get_xc_of_meta_ggas_matches_jax(name):
    j, t = jgetxc.get_xc(name), tgetxc.get_xc(name)
    assert (t.family, t.exx_fraction, t.exx_lr) == \
        (j.family, j.exx_fraction, j.exx_lr) and t.family == 4


# --- SCF ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_scan():
    """JAX SCAN H2O/3-21G grid 1: energy, dm, theta and grid tables as
    numpy, the JAX engine's Fock and energy at dm, and jax.jvp of its Fock
    in dm along a seeded symmetric direction."""
    mol = dqc_tpu.Mol(H2O, basis="3-21G", grid=1)
    qc = dqc_tpu.KS(mol, xc="scan", opts=JOptions(mixed=False)).run()
    th, dm = qc._theta, qc._dm
    v = np.random.default_rng(3).standard_normal(np.shape(dm))
    v = v + v.T
    jvp = jax.jit(lambda d, t, u: jax.jvp(
        lambda x: qc.engine.fock(x, t), (d,), (u,))[1])
    out = {
        "energy": float(qc.energy()), "dm": np.asarray(dm), "v": v,
        "fock": np.asarray(qc.engine.fock(dm, th)),
        "e_dm": float(qc.engine.energy(dm, th)),
        "jvp": np.asarray(jvp(dm, th, jnp.asarray(v))),
        "theta": {k: np.asarray(th[k]) for k in
                  ("hcore", "ovlp", "X", "keep", "enuc", "occ", "eri")},
        "grid": [np.asarray(th["grid"][k]) for k in
                 ("coords", "dvol", "ao", "ao_grad", "ao_lapl")]}
    return out


def test_scan_ks_matches_jax():
    ref = _jax_scan()
    mol = dqt.Mol(H2O, basis="3-21G", grid=1, device="cpu")
    qc = dqt.KS(mol, xc="scan").run()
    assert qc.stats["residual"] <= qc.opts.tol
    assert "ao_lapl" in qc._theta["grid"]
    assert abs(float(qc.energy()) - ref["energy"]) <= 1e-10

    # the family-4 route on identical tables, at the JAX density
    tt = theta_from_numpy(ref["theta"], device="cpu")
    tt["grid"] = grid_theta_from_numpy(*ref["grid"], device="cpu")
    eng = tengine.KSEngine(tgetxc.get_xc("scan"))
    d = torch.tensor(ref["dm"])
    assert np.abs(eng.fock(d, tt).numpy() - ref["fock"]).max() <= 1e-11
    assert abs(float(eng.energy(d, tt)) - ref["e_dm"]) <= 1e-11
    # ... and under autograd: the Fock matrix's derivative in dm carries
    # f_xc through lapl and tau
    _, got = torch.autograd.functional.jvp(
        lambda x: eng.fock(x, tt), d, torch.as_tensor(ref["v"]))
    assert np.abs(got.numpy() - ref["jvp"]).max() <= 1e-9


@pytest.mark.parametrize("polarized", [False, True])
def test_mgga_vxc_is_the_symmetrised_derivative(polarized):
    """V_xc assembled in closed form (K2/K3's plain versions for rho and
    grad, plain torch for lapl and tau) equals autograd of E_xc in dm, and
    is symmetric."""
    mol = dqt.Mol(H2O, basis="3-21G", grid=1, device="cpu")
    from dqc_tpu_torch.xc.integrate import setup_grid_theta
    tabs = setup_grid_theta(mol.meta, mol.params, mol.setup_grid(),
                            family=4)
    rng = np.random.default_rng(4)
    nao = mol.meta.nao
    a = rng.standard_normal((nao, nao)) * 0.05
    dm = torch.as_tensor(a @ a.T)
    if polarized:
        b = rng.standard_normal((nao, nao)) * 0.05
        dm = torch.stack([dm, torch.as_tensor(b @ b.T)])
    xc = tgetxc.get_xc("scan")
    v = tint.vxc_matrix(xc, dm, tabs, polarized)
    v_ad = tint.vxc_matrix_ad(xc, dm, tabs, polarized)
    assert torch.isfinite(v).all()
    assert float((v - v_ad).abs().max()) <= 1e-12 * float(v_ad.abs().max())
    assert torch.equal(v, v.transpose(-1, -2))


def _mirror(F, axis):
    """H2O forces mapped by axis -> -axis (y swaps the two H atoms)."""
    G = F.copy()
    if axis == 1:
        G[[1, 2]] = G[[2, 1]]
    G[:, axis] *= -1
    return G


@pytest.mark.parametrize("xc", ["tpss", "scan"])
def test_mgga_forces_keep_the_mirror_symmetry_of_water(xc):
    """Forces through tau and lapl: H2O lies in the yz-plane and is
    symmetric under y -> -y, and so are its grid and Becke weights, so
    exact forces are too (the pattern of test_torch_grad's benzene test);
    one component against a central difference of the energy."""
    mol = dqt.Mol(H2O, basis="sto-3g", grid=1, device="cpu")
    qc = dqt.KS(mol, xc=xc, opts=dqt.SCFOptions(tol=1e-11))
    F = -qc.energy_grad()["basis"]["atompos"].numpy()
    assert np.isfinite(F).all()
    for axis in (0, 1):
        assert np.abs(F - _mirror(F, axis)).max() <= 1e-10
    assert np.abs(F.sum(0)).max() <= 1e-9
    p0 = qc._all_params()
    pos0 = p0["basis"]["atompos"]
    es = []
    h = 1e-4
    for sgn in (1, -1):
        pos = pos0.clone()
        pos[1, 2] += sgn * h
        with torch.no_grad():
            es.append(float(qc.energy_fn(
                dict(p0, basis=dict(p0["basis"], atompos=pos)))))
    assert abs(-(es[0] - es[1]) / (2 * h) - F[1, 2]) <= 1e-7
