"""PyTorch/CUDA port: CustomXC, the neural-XC hook, against the JAX package,
on the CPU.

The same NN (the functional of examples/04_neural_xc.py with the reduced
gradient s = |grad rho| / rho^(4/3) as a second input, so that a GGA's
kernels carry it) runs through both packages on the same seeded numpy
parameters (convert.xc_params_from_numpy). Pointwise: the energy density
through _edens_at and its derivatives in the densities and in the
parameters, to 1e-12 relative. SCF: H2/3-21G grid 1, the converged energy
within 1e-10 Ha of the JAX package's and energy_grad()['xc_params']
against jax.grad of its energy_fn in the parameters within 1e-8; the
port's parameter gradient against its own central differences.
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
from dqc_tpu.xc import integrate as jint
from dqc_tpu.xc.custom import CustomXC as JCustomXC
from dqc_tpu_torch.convert import xc_params_from_numpy
from dqc_tpu_torch.xc import integrate as tint
from dqc_tpu_torch.xc.custom import CustomXC

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2 = "H -0.7 0 0; H 0.7 0 0"
CX = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)


def _params_np(seed=8):
    rng = np.random.default_rng(seed)
    return {"w1": 0.5 * rng.standard_normal(8),
            "ws": 0.5 * rng.standard_normal(8),
            "b1": 0.1 * rng.standard_normal(8),
            "w2": 0.5 * rng.standard_normal((8, 1)),
            "b2": 0.1 * rng.standard_normal(1)}


def _nn(xp, p, rho, sigma=None, tau=None):
    """-Cx rho^(4/3) (1 + 0.2 tanh(NN(rho^(1/3), s[, tau/rho^(5/3)]))), in
    the array module xp (jnp or torch)."""
    n43 = rho ** (4.0 / 3.0)
    h = rho[..., None] ** (1.0 / 3.0) * p["w1"] + p["b1"]
    if sigma is not None:
        s = xp.sqrt(xp.maximum(sigma, 1e-40 + 0 * sigma)) / n43
        h = h + s[..., None] * p["ws"]
    if tau is not None:
        h = h + (tau / rho ** (5.0 / 3.0))[..., None] * 0.1 * p["ws"]
    f = 1.0 + 0.2 * xp.tanh(xp.tanh(h) @ p["w2"] + p["b2"])[..., 0]
    return -CX * n43 * f


def _edens(xp, family, polarized):
    def fn(p, d):
        if not polarized:
            return _nn(xp, p, d["rho"], d.get("sigma"), d.get("tau"))
        # exchange-like spin scaling: (e[2 rho_u] + e[2 rho_d]) / 2
        out = 0.0
        for s, ss in (("u", "uu"), ("d", "dd")):
            sig = 4.0 * d[f"sigma_{ss}"] if family >= 2 else None
            tau = 2.0 * d[f"tau_{s}"] if family >= 4 else None
            out = out + 0.5 * _nn(xp, p, 2.0 * d[f"rho_{s}"], sig, tau)
        return out
    return fn


def _dens(family, polarized, rng):
    rho = np.concatenate([[0.0, 1e-13, 1e-12, 2e-12],
                          10.0 ** rng.uniform(-10, 1, 20)])
    grad = rng.standard_normal((3, rho.size)) * rho ** (4.0 / 3.0)
    tau = (np.sum(grad ** 2, axis=0) / (8.0 * np.maximum(rho, 1e-30))
           + rng.uniform(0, 3, rho.size) * rho ** (5.0 / 3.0))
    lapl = rng.standard_normal(rho.size) * rho

    def one(f):
        d = {"rho": f * rho}
        if family >= 2:
            d["grad"] = f * grad
        if family >= 4:
            d.update(lapl=f * lapl, tau=f * tau)
        return d
    return {"u": one(0.55), "d": one(0.45)} if polarized else one(1.0)


def _close(t, j, rel):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = np.abs(j).max()
    assert np.abs(t - j).max() <= rel * scale, np.abs(t - j).max() / scale


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("family", [1, 2, 4])
def test_custom_xc_pointwise_matches_jax(family, polarized):
    """_edens_at of a CustomXC (apply_pol/apply_unpol with the xc_params
    dict) and its derivatives in the densities and in the NN parameters."""
    pnp = _params_np()
    dens = _dens(family, polarized, np.random.default_rng(family))
    jxc = JCustomXC(_edens(jnp, family, polarized),
                    {k: jnp.asarray(v) for k, v in pnp.items()},
                    family=family, key="nn")
    txc = CustomXC(_edens(torch, family, polarized),
                   xc_params_from_numpy(pnp, device="cpu"), family=family,
                   key="nn")
    jd = jax.tree_util.tree_map(jnp.asarray, dens)
    jp = {"nn": {k: jnp.asarray(v) for k, v in pnp.items()}}
    je, (jgd, jgp) = jax.value_and_grad(
        lambda d, p: jnp.sum(jint._edens_at(jxc, d, polarized, p)),
        argnums=(0, 1))(jd, jp)
    td = jax.tree_util.tree_map(
        lambda v: torch.tensor(np.asarray(v), requires_grad=True), dens)
    tp = {"nn": {k: torch.tensor(v, requires_grad=True)
                 for k, v in pnp.items()}}
    leaves = jax.tree_util.tree_leaves(td) + list(tp["nn"].values())
    te = torch.sum(tint._edens_at(txc, td, polarized, tp))
    tg = torch.autograd.grad(te, leaves, allow_unused=True)
    tg = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, tg)]
    _close(te, je, 1e-12)
    ref = jax.tree_util.tree_leaves(jgd) + [jgp["nn"][k] for k in tp["nn"]]
    for a, b in zip(tg, ref):
        assert torch.isfinite(a).all()
        _close(a, b, 1e-12)
    # without xc_params the functional takes its init_params
    e0 = torch.sum(tint._edens_at(txc, td, polarized, None))
    assert float(e0.detach()) == float(te.detach())


def test_xc_params_from_numpy_keeps_the_tree():
    tree = {"a": np.arange(3.0), "b": [np.ones((2, 2)), 0.5],
            "c": {"d": np.float32(2.0)}}
    out = xc_params_from_numpy(tree, device="cpu")
    assert out["a"].dtype == torch.float64 and out["a"].shape == (3,)
    assert isinstance(out["b"], list) and out["b"][1].shape == ()
    assert float(out["c"]["d"]) == 2.0
    tree["a"][0] = 7.0            # a copy, never a view of the caller's
    assert float(out["a"][0]) == 0.0


@functools.lru_cache(maxsize=None)
def _jax_h2():
    """JAX H2/3-21G grid 1 with the family-2 NN: energy and jax.grad of
    energy_fn in the NN parameters."""
    pnp = _params_np()
    p0 = {k: jnp.asarray(v) for k, v in pnp.items()}
    xc = JCustomXC(_edens(jnp, 2, False), p0, family=2, key="nn")
    mol = dqc_tpu.Mol(H2, basis="3-21G", grid=1)
    qc = dqc_tpu.KS(mol, xc=xc, opts=JOptions(mixed=False, tol=1e-11))
    e = float(qc.run().energy())
    base = qc._all_params()

    def ene(xp):
        p = dict(base)
        p["xc_params"] = {"nn": xp}
        return qc.energy_fn(p)
    g = jax.jit(jax.grad(ene))(p0)
    return e, {k: np.asarray(v) for k, v in g.items()}


def _port_h2():
    xc = CustomXC(_edens(torch, 2, False),
                  xc_params_from_numpy(_params_np(), device="cpu"),
                  family=2, key="nn")
    mol = dqt.Mol(H2, basis="3-21G", grid=1, device="cpu")
    return dqt.KS(mol, xc=xc, opts=dqt.SCFOptions(tol=1e-11))


def test_custom_xc_energy_and_param_grad_match_jax():
    e_jax, g_jax = _jax_h2()
    qc = _port_h2().run()
    assert abs(float(qc.energy()) - e_jax) <= 1e-10
    assert set(qc._all_params()["xc_params"]) == {"nn"}
    g = qc.energy_grad()["xc_params"]["nn"]
    for k, v in g_jax.items():
        assert np.abs(g[k].numpy() - v).max() <= 1e-8, k
    # the SCF loop keeps no graph of the parameters
    assert not qc.energy().requires_grad


def test_custom_xc_param_grad_matches_central_differences():
    """energy_grad()['xc_params'] along a seeded direction against central
    differences of energy_fn (h = 1e-4): 1e-6 relative."""
    qc = _port_h2().run()
    g = qc.energy_grad()["xc_params"]["nn"]
    rng = np.random.default_rng(2)
    p0 = qc._all_params()
    nn0 = p0["xc_params"]["nn"]
    v = {k: torch.as_tensor(rng.standard_normal(t.shape)) for k, t in
         nn0.items()}
    slope = sum(float((g[k] * v[k]).sum()) for k in v)
    h = 1e-4
    es = []
    for sgn in (1, -1):
        nn = {k: nn0[k] + sgn * h * v[k] for k in nn0}
        with torch.no_grad():
            es.append(float(qc.energy_fn(dict(p0, xc_params={"nn": nn}))))
    fd = (es[0] - es[1]) / (2 * h)
    assert abs(fd - slope) <= 1e-6 * abs(slope)
