"""PyTorch/CUDA port: range-separated hybrids against the JAX package, on
the CPU.

Pointwise: the erf attenuation F(a) (both branches and the seam at a = 6,
out to a = 1e6 where the closed form alone would cancel to garbage), the
short-range functionals LDA_X_ERF and GGA_X_ITYH_B88 and the composites
that hold them, value and first derivatives against jax.grad on a density
sweep from 1e-12 up, to 1e-12 relative to the largest value of each array
(the same float64 formulas, math libraries that differ in the last bits);
derivative entries where the closed form of F(a) cancels are held to the
reference's own spread under one-ulp changes of its inputs besides (see
the test).

get_xc: every name of the omega registry and the range-separated
composites resolve to the same family, exx_fraction and exx_lr.

SCF: LC-LDA and CAM-B3LYP on H2O/STO-3G grid 1, restricted and polarized
(the triplet): the converged energies of the two packages, each on its own
integrals and grid, within 1e-10 Ha; the port's engine on the JAX
package's theta (eri and the attenuated eri_lr0 carried across) gives the
same Fock matrix and energy at the JAX density to 1e-11. Forces of LC-LDA
(H2/STO-3G grid 1, the pattern of tests/test_rsh.py) against jax.grad of
the JAX package's energy_fn to 1e-7. Each JAX run happens once per
process (lru_cache).
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
from dqc_tpu.xc import lda as jlda
from dqc_tpu_torch.convert import grid_theta_from_numpy, theta_from_numpy
from dqc_tpu_torch.scf import engine as tengine
from dqc_tpu_torch.xc import getxc as tgetxc
from dqc_tpu_torch.xc import lda as tlda

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
LC_LDA = "lda_x_erf(0.5) + 1*lr_hf(0.5) + lda_c_pw"   # tests/test_rsh.py


def _close(t, j, rel):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = np.abs(j).max()
    err = np.abs(t - j).max()
    assert err <= rel * scale or scale == np.abs(t).max() == 0, err / scale


def _sweep(polarized):
    """rho from 1e-12 to 1e2 with reduced gradients from tiny to large;
    polarized: spin fractions from nearly empty to full."""
    rng = np.random.default_rng(15)
    rho = 10.0 ** np.linspace(-12, 2, 57)
    s = 10.0 ** rng.uniform(-4, 1, rho.size)
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


# --- pointwise ---------------------------------------------------------------

def test_erf_attenuation_matches_jax():
    """F(a) and F'(a) from 1e-6 to 1e6, the seam a = 6 and its
    neighbours included."""
    a = np.concatenate([10.0 ** np.linspace(-6, 6, 61),
                        [6.0 - 1e-9, 6.0, 6.0 + 1e-9, 5.5, 6.5]])
    ta = torch.tensor(a, requires_grad=True)
    tf = tlda._erf_attenuation(ta)
    (tg,) = torch.autograd.grad(tf.sum(), ta)
    jf = jlda._erf_attenuation(jnp.asarray(a))
    jg = jax.grad(lambda x: jnp.sum(jlda._erf_attenuation(x)))(jnp.asarray(a))
    _close(tf, jf, 1e-12)
    _close(tg, jg, 1e-12)
    # the series keeps F small and positive where the closed form fails
    tf = tf.detach()
    assert bool((tf[a > 6.0] > 0).all()) and float(tf[-6]) < 1e-12


RSH_FUNCTIONALS = ["lda_x_erf(0.33)", "lda_x_erf(1e+4)",
                   "gga_x_ityh_b88(0.33)", "gga_x_ityh_b88(1e5)",
                   "camb3lyp", "lc-blyp",
                   "0.25*hf + -0.25*lr_hf(0.11) + lda_x_erf(0.11)"]


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("name", RSH_FUNCTIONALS)
def test_rsh_edens_and_derivatives_match_jax(name, polarized):
    jxc, txc = jgetxc.get_xc(name), tgetxc.get_xc(name)
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
    grad = jax.grad(jsum, argnums=tuple(range(len(keys))))
    jg = [np.asarray(g) for g in grad(*jvals)]
    _close(te, je, 1e-12)
    # For a between about 1 and 6 the closed form of F(a) cancels its 4a^3
    # terms, so the reference's own derivatives move by up to ~3e-7
    # relative when its inputs move by a few ulp. Each derivative entry is
    # held to 1e-12 of its array's scale plus four times that spread,
    # measured here on the reference over 16 such moves (zero wherever F
    # is well conditioned).
    spread = [np.zeros_like(g) for g in jg]
    for k in [k for k in range(-8, 9) if k]:
        gk = grad(*[v * (1.0 + k * 2.0 ** -52) for v in jvals])
        spread = [np.maximum(sp, np.abs(np.asarray(a) - b))
                  for sp, a, b in zip(spread, gk, jg)]
    for a, b, sp in zip(tg, jg, spread):
        assert torch.isfinite(a).all()
        err = np.abs(a.numpy() - b)
        assert (err <= 1e-12 * np.abs(b).max() + 4.0 * sp).all(), \
            float((err / (1e-12 * np.abs(b).max() + 4.0 * sp)).max())


OMEGA_NAMES = ["lr_hf(0.33)", "sr_hf(0.11)", "lda_x_erf(0.3)",
               "gga_x_ityh_b88(0.33)", "lr_hf(1e+4)", "camb3lyp",
               "cam-b3lyp", "lc-blyp", "lc_blyp",
               "0.19*hf + 0.46*lr_hf(0.33) + 0.35*gga_x_b88"
               " + 0.46*gga_x_ityh_b88(0.33)",
               "lr_hf(0.3) + 0.5*lr_hf(0.3) + lr_hf(0.30000000000000004)",
               "lr_hf(0.3) + -1*lr_hf(0.3) + lda_x",
               "hf + lr_hf(0.2) + -0.5*lr_hf(0.4)"]


@pytest.mark.parametrize("name", OMEGA_NAMES)
def test_get_xc_of_range_separation_matches_jax(name):
    """family, exx_fraction and exx_lr (coefficients of equal omegas
    merged, zero terms dropped) as in the JAX package."""
    j, t = jgetxc.get_xc(name), tgetxc.get_xc(name)
    assert (t.family, t.exx_fraction) == (j.family, j.exx_fraction)
    assert t.exx_lr == j.exx_lr


@pytest.mark.parametrize("name", ["lr_hf(0.3.3)", "lr_hf()", "no_hf(0.3)"])
def test_malformed_omega_names_raise(name):
    with pytest.raises(NotImplementedError):
        jgetxc.get_xc(name)
    with pytest.raises(NotImplementedError):
        tgetxc.get_xc(name)


# --- SCF ---------------------------------------------------------------------

CASES = {
    "lc-lda-restricted": dict(xc=LC_LDA, spin=None),
    "lc-lda-polarized": dict(xc=LC_LDA, spin=2),
    "camb3lyp-restricted": dict(xc="camb3lyp", spin=None),
    "camb3lyp-polarized": dict(xc="camb3lyp", spin=2),
}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """JAX KS run: (energy, dm, theta as numpy, grid tables as numpy,
    Fock and energy of the JAX engine at dm)."""
    c = CASES[case]
    mol = dqc_tpu.Mol(H2O, basis="sto-3g", grid=1, spin=c["spin"])
    qc = dqc_tpu.KS(mol, xc=c["xc"], opts=JOptions(mixed=False)).run()
    th = qc._theta
    dm = qc._dm
    fock = np.asarray(qc.engine.fock(dm, th))
    e_dm = float(qc.engine.energy(dm, th))
    theta_np = {k: np.asarray(th[k]) for k in
                ("hcore", "ovlp", "X", "keep", "enuc", "occ", "eri",
                 "eri_lr0")}
    g = th["grid"]
    grid_np = [np.asarray(g[k]) for k in ("coords", "dvol", "ao")]
    grid_np.append(np.asarray(g["ao_grad"]) if "ao_grad" in g else None)
    return (float(qc.energy()), np.asarray(dm), theta_np, grid_np, fock,
            e_dm)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rsh_ks_matches_jax(case):
    e_jax, dm, theta_np, grid_np, fock_jax, e_dm_jax = _jax_run(case)
    c = CASES[case]
    mol = dqt.Mol(H2O, basis="sto-3g", grid=1, spin=c["spin"], device="cpu")
    qc = dqt.KS(mol, xc=c["xc"]).run()
    assert qc.stats["residual"] <= qc.opts.tol
    assert "eri_lr_k0" in qc._theta and "eri_lr_s" in qc.stats
    # each package on its own integrals and grid, both at a residual of
    # 1e-8 or below: the energy error is quadratic in it
    assert abs(float(qc.energy()) - e_jax) <= 1e-10

    # the port's engine on the JAX package's theta, at the JAX density
    tt = theta_from_numpy(theta_np, device="cpu")
    tt["eri_lr_k0"] = torch.tensor(theta_np["eri_lr0"]).permute(
        0, 2, 1, 3).contiguous()
    tt["grid"] = grid_theta_from_numpy(*grid_np, device="cpu")
    eng = tengine.KSEngine(tgetxc.get_xc(c["xc"]),
                           polarized=c["spin"] is not None)
    d = torch.tensor(dm)
    assert np.abs(eng.fock(d, tt).numpy() - fock_jax).max() <= 1e-11
    assert abs(float(eng.energy(d, tt)) - e_dm_jax) <= 1e-11
    # the long-range K of the engine is the JAX package's einsum
    klr = eng._k_lr(tt, d, 0)
    ref = np.einsum("ikjl,...kl->...ij", theta_np["eri_lr0"], dm)
    assert np.abs(klr.numpy() - ref).max() <= 1e-12


def test_k_lr_shared_by_fock_and_energy():
    """K_lr computed once per Fock build can be handed to both the Fock
    matrix and the energy; they equal what each computes by itself."""
    _, dm, theta_np, grid_np, fock_jax, e_dm_jax = _jax_run(
        "camb3lyp-restricted")
    tt = theta_from_numpy(theta_np, device="cpu")
    tt["eri_lr_k0"] = torch.tensor(theta_np["eri_lr0"]).permute(
        0, 2, 1, 3).contiguous()
    tt["grid"] = grid_theta_from_numpy(*grid_np, device="cpu")
    eng = tengine.KSEngine(tgetxc.get_xc("camb3lyp"))
    d = torch.tensor(dm)
    j, k = eng.jk_parts(d, tt)
    klr = eng.lr_parts(d, tt)
    f = eng.fock_from_parts(d, j, k, tt, klr=klr)
    e = eng.energy_from_parts(d, j, k, tt, klr=klr)
    assert torch.equal(f, eng.fock(d, tt))
    assert float(e) == float(eng.energy(d, tt))
    assert np.abs(f.numpy() - fock_jax).max() <= 1e-11


@functools.lru_cache(maxsize=None)
def _jax_lc_lda_forces():
    mol = dqc_tpu.Mol("H -0.7 0 0; H 0.7 0 0", basis="sto-3g", grid=1)
    qc = dqc_tpu.KS(mol, xc=LC_LDA, opts=JOptions(mixed=False))
    p0 = qc._all_params()

    def e_of_pos(pos):
        p = dict(p0)
        p["basis"] = dict(p0["basis"])
        p["basis"]["atompos"] = pos
        return qc.energy_fn(p)
    pos0 = p0["basis"]["atompos"]
    return np.asarray(jax.jit(jax.grad(e_of_pos))(pos0))


def test_lc_lda_forces_match_jax():
    """dE/dR through the implicit SCF with the attenuated ERI and the
    short-range LDA chain, against jax.grad of the JAX package's
    energy_fn."""
    g_jax = _jax_lc_lda_forces()
    mol = dqt.Mol("H -0.7 0 0; H 0.7 0 0", basis="sto-3g", grid=1,
                  device="cpu")
    qc = dqt.KS(mol, xc=LC_LDA, opts=dqt.SCFOptions(tol=1e-11))
    g = qc.energy_grad()["basis"]["atompos"].numpy()
    assert np.abs(g - g_jax).max() <= 1e-7
    assert abs(g.sum(0)).max() <= 1e-9
