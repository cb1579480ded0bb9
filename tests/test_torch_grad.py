"""PyTorch/CUDA port: derivatives against the JAX package, on the CPU.

The derivative rules (boys_list, safe_eigh, the three kernel Functions on
their plain versions), the Fock Jacobian of Kohn-Sham, and forces by
implicit differentiation of the SCF. JAX-side results come from
module-scoped caches, each computed once. Tolerances are written beside
each check.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.scf import eigh as jeigh
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu_torch.convert import grid_theta_from_numpy, theta_from_numpy
from dqc_tpu_torch.ops import hopper_jk, hopper_xc
from dqc_tpu_torch.ops.boys import boys_list
from dqc_tpu_torch.scf import engine as tengine
from dqc_tpu_torch.scf.eigh import eigh_density, safe_eigh
from dqc_tpu_torch.scf.orth import orthogonalizer
from dqc_tpu_torch.scf.fixed_point import SCFOptions
from dqc_tpu_torch.xc import getxc as tgetxc

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
H2 = "H 0 0 0; H 0 0 1.4"
G = torch.autograd.gradcheck
GG = torch.autograd.gradgradcheck


# --- the Fock Jacobian of Kohn-Sham ----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ks_fock_jvp():
    """JAX B3LYP H2O/3-21G grid 1: theta as numpy, dm, a seeded symmetric
    direction v and jax.jvp of KSEngine.fock in dm along v."""
    mol = dqc_tpu.Mol(H2O, basis="3-21G", grid=1)
    qc = dqc_tpu.KS(mol, xc="b3lyp", opts=JOptions(mixed=False)).run()
    th = qc._theta
    v = np.random.default_rng(0).standard_normal(np.shape(qc._dm))
    v = v + v.T
    jvp = jax.jit(lambda d, t, u: jax.jvp(
        lambda x: qc.engine.fock(x, t), (d,), (u,))[1])
    out = np.asarray(jvp(qc._dm, th, jnp.asarray(v)))
    theta_np = {k: np.asarray(th[k]) for k in
                ("hcore", "ovlp", "X", "keep", "enuc", "occ", "eri")}
    g = th["grid"]
    grid_np = [np.asarray(g[k]) for k in ("coords", "dvol", "ao", "ao_grad")]
    return theta_np, grid_np, np.asarray(qc._dm), v, out


def test_ks_fock_jvp_matches_jax():
    """The derivative of KSEngine.fock in dm carries f_xc (it was missing
    while the pointwise adjoints were detached). Same theta, grid tables
    and dm on both sides; 1e-9 on entries of order 1 to 10."""
    theta_np, grid_np, dm, v, ref = _jax_ks_fock_jvp()
    tt = theta_from_numpy(theta_np, device="cpu")
    tt["grid"] = grid_theta_from_numpy(*grid_np, device="cpu")
    eng = tengine.KSEngine(tgetxc.get_xc("b3lyp"))
    _, got = torch.autograd.functional.jvp(
        lambda d: eng.fock(d, tt), torch.as_tensor(dm), torch.as_tensor(v))
    assert np.abs(got.numpy() - ref).max() <= 1e-9


# --- derivative rules --------------------------------------------------------

@pytest.mark.parametrize("mmax", [0, 2, 4])
def test_boys_list_gradcheck(mmax):
    """dF_m/dT = -F_{m+1} to second order, on both branches (T < 27 by the
    series, T > 27 by the erf form)."""
    T = torch.tensor([1e-3, 0.3, 5.0, 26.5, 27.5, 40.0],
                     dtype=torch.float64, requires_grad=True)

    def f(t):
        return tuple(boys_list(t, mmax))
    assert G(f, (T,))
    assert GG(f, (T,))


def _occupied_dm(a, nocc):
    w, v = safe_eigh(0.5 * (a + a.transpose(-1, -2)))
    return w, v[:, :nocc] @ v[:, :nocc].T


def test_safe_eigh_gradcheck():
    """Eigenvalues and the occupied projector of a symmetric matrix without
    degeneracies, to second order (the Lorentzian rule is exact there)."""
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.standard_normal((5, 5)), requires_grad=True)
    assert G(lambda x: _occupied_dm(x, 2), (a,))
    assert GG(lambda x: _occupied_dm(x, 2), (a,))


def _np_projector(m, nocc=3):
    _, v = np.linalg.eigh(0.5 * (m + m.T))
    return v[:, :nocc] @ v[:, :nocc].T


def test_safe_eigh_degenerate_pair_matches_jax():
    """A matrix with an exactly degenerate occupied pair: the derivative of
    the occupied projector is finite, and agrees with jax.vjp of the JAX
    package's safe_eigh to 1e-6 and with central differences of the
    projector (numpy's eigh, h = 1e-6) to 1e-8. The JAX rule keeps
    F = d/(d^2 + eps^2) at a gap d of rounding size, which amplifies
    rounding (6.3e-8 from the differences here); the port treats such a gap
    as the exact zero it stands for (1.4e-9 from the differences)."""
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.standard_normal((5, 5)))
    a = q @ np.diag([1.0, 2.0, 2.0, 3.5, 5.0]) @ q.T
    a = 0.5 * (a + a.T)
    ct = rng.standard_normal((5, 5))
    x = torch.tensor(a, requires_grad=True)
    _, dm = _occupied_dm(x, 3)
    (got,) = torch.autograd.grad((dm * torch.as_tensor(ct)).sum(), x)

    def jdm(m):
        w, v = jeigh.safe_eigh(0.5 * (m + m.T))
        return v[:, :3] @ v[:, :3].T
    _, vjp = jax.vjp(jdm, jnp.asarray(a))
    (ref,) = vjp(jnp.asarray(ct))
    h = 1e-6
    fd = np.zeros((5, 5))
    for i in range(5):
        for j in range(5):
            e = np.zeros((5, 5))
            e[i, j] = h
            fd[i, j] = ((_np_projector(a + e) - _np_projector(a - e))
                        * ct).sum() / (2 * h)
    assert np.all(np.isfinite(got.numpy()))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6
    assert np.abs(got.numpy() - fd).max() <= 1e-8


def _split_level_matrix(rng, n=6):
    """A symmetric matrix whose doubly degenerate levels (1.0 and 2.0) are
    split by 1e-11, as an SCF splits the degenerate orbitals of a
    symmetric molecule."""
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.array([0.5, 1.0, 1.0 + 1e-11, 2.0, 2.0 + 1e-11, 3.5])[:n]
    return q @ np.diag(w) @ q.T


def _np_density(f, s, nocc):
    """dm of the lowest nocc orbitals of F C = S C e (numpy, occupation 2)."""
    x = np.linalg.inv(np.linalg.cholesky(s)).T
    _, u = np.linalg.eigh(x.T @ f @ x)
    c = x @ u[:, :nocc]
    return 2.0 * c @ c.T


def test_eigh_density_levels_split_by_rounding():
    """The density matrix of a matrix whose occupied and virtual levels are
    degenerate up to a 1e-11 split: eigh_density's derivative against
    central differences (numpy, h = 1e-6) to 1e-8. Through safe_eigh's
    eigenvectors the same derivative carries 1/split times rounding."""
    rng = np.random.default_rng(6)
    a = _split_level_matrix(rng)
    ct = rng.standard_normal(a.shape)
    occ = torch.tensor([2.0, 2.0, 2.0, 0.0, 0.0, 0.0])
    x = torch.tensor(a, requires_grad=True)
    dm, _, _ = eigh_density(x, occ)
    (got,) = torch.autograd.grad((dm * torch.as_tensor(ct)).sum(), x)
    h = 1e-6
    fd = np.zeros(a.shape)
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            e = np.zeros(a.shape)
            e[i, j] = h
            ap, am = a + e, a - e
            fd[i, j] = ((_np_density(0.5 * (ap + ap.T), np.eye(6), 3)
                         - _np_density(0.5 * (am + am.T), np.eye(6), 3))
                        * ct).sum() / (2 * h)
    assert np.abs(got.numpy() - fd).max() <= 1e-8


def test_orthogonalizer_derivative_with_degenerate_overlap():
    """dm(F, S) through orthogonalizer(S) and the SCF's dm map, for an S
    with levels split by 1e-11: the derivative in S against central
    differences of the generalized eigenproblem (numpy, h = 1e-6) to
    1e-8, and to second order by gradgradcheck."""
    rng = np.random.default_rng(7)
    s = _split_level_matrix(rng) + 2.0 * np.eye(6)
    f = rng.standard_normal((6, 6))
    f = f + f.T
    ct = rng.standard_normal((6, 6))
    occ = torch.tensor([2.0, 2.0, 2.0, 0.0, 0.0, 0.0], dtype=torch.float64)

    def dm_of(sm):
        sm = 0.5 * (sm + sm.transpose(-1, -2))
        x, keep = orthogonalizer(sm)
        return tengine.orthogonal_fock_to_dm(torch.as_tensor(f), x, keep,
                                             occ)[0]
    st = torch.tensor(s, requires_grad=True)
    (got,) = torch.autograd.grad((dm_of(st) * torch.as_tensor(ct)).sum(), st)
    h = 1e-6
    fd = np.zeros(s.shape)
    for i in range(6):
        for j in range(6):
            e = np.zeros(s.shape)
            e[i, j] = h
            sp, sm_ = s + e, s - e
            fd[i, j] = ((_np_density(f, 0.5 * (sp + sp.T), 3)
                         - _np_density(f, 0.5 * (sm_ + sm_.T), 3))
                        * ct).sum() / (2 * h)
    assert np.abs(got.numpy() - fd).max() <= 1e-8
    s_small = torch.tensor(_split_level_matrix(rng, 4)[:4, :4]
                           + 2.0 * np.eye(4), requires_grad=True)
    f = f[:4, :4]
    occ = occ[:4]
    assert GG(dm_of, (s_small,))


# --- the kernel Functions on their plain versions ----------------------------

def _sym_eri_k(t):
    """A tensor with the ERI symmetries, in the exchange layout."""
    t = t + t.permute(1, 0, 2, 3)
    t = t + t.permute(0, 1, 3, 2)
    t = t + t.permute(2, 3, 0, 1)
    return t.permute(0, 2, 1, 3).contiguous()


def _rand(*shape, seed):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape),
                        requires_grad=True)


def test_ds_jk_function_gradcheck():
    """First and second order through the K1 Function, whose dm cotangent
    is ds_jk of the cotangents (T given the ERI symmetries)."""
    t, dm = _rand(3, 3, 3, 3, seed=3), _rand(3, 3, seed=4)

    def f(t, d):
        return hopper_jk.ds_jk(_sym_eri_k(t), d)
    assert G(f, (t, dm))
    assert GG(f, (t, dm))


def test_ds_dens_and_vxc_functions_gradcheck():
    """First and second order through the K2 and K3 Functions: each one's
    potential or density cotangent is the other kernel."""
    ao, ag = _rand(6, 4, seed=5), _rand(3, 6, 4, seed=6)
    dm, vr, vg = _rand(4, 4, seed=7), _rand(6, seed=8), _rand(3, 6, seed=9)
    assert G(hopper_xc.ds_dens_gga, (ao, ag, dm))
    assert GG(hopper_xc.ds_dens_gga, (ao, ag, dm))
    assert G(hopper_xc.ds_vxc_gga, (ao, ag, vr, vg))
    assert GG(hopper_xc.ds_vxc_gga, (ao, ag, vr, vg))


@pytest.mark.parametrize("which", ["ds_jk", "ds_dens_gga", "ds_vxc_gga"])
def test_kernel_functions_match_autograd_of_plain_formulas(which):
    """The hand-written backward rules against autograd through the plain
    formulas on the same inputs (1e-12 relative)."""
    if which == "ds_jk":
        with torch.no_grad():
            t = _sym_eri_k(_rand(5, 5, 5, 5, seed=10))
        inputs = [t, _rand(5, 5, seed=11)]
        fn, plain = hopper_jk.ds_jk, hopper_jk.ds_jk_reference
    elif which == "ds_dens_gga":
        inputs = [_rand(9, 5, seed=12), _rand(3, 9, 5, seed=13),
                  _rand(5, 5, seed=14)]
        fn, plain = hopper_xc.ds_dens_gga, hopper_xc.ds_dens_reference
    else:
        inputs = [_rand(9, 5, seed=15), _rand(3, 9, 5, seed=16),
                  _rand(9, seed=17), _rand(3, 9, seed=18)]
        fn, plain = hopper_xc.ds_vxc_gga, hopper_xc.ds_vxc_reference
    inputs = [x.detach().requires_grad_(True) for x in inputs]

    def grads(f):
        outs = f(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        dot = sum(((i + 1.0) * o).sum() for i, o in enumerate(outs))
        return torch.autograd.grad(dot, inputs)
    for a, r in zip(grads(fn), grads(plain)):
        assert (a - r).abs().max() <= 1e-12 * r.abs().max()


def test_ds_jk_backward_refuses_t_without_pair_symmetry():
    t = _rand(4, 4, 4, 4, seed=19)
    dm = _rand(4, 4, seed=20)
    k, j = hopper_jk.ds_jk(t, dm)
    with pytest.raises(ValueError, match="pair symmetry"):
        torch.autograd.grad(k.sum() + j.sum(), dm)


# --- forces by implicit differentiation --------------------------------------

CASES = {"hf": None, "b3lyp": "b3lyp"}


def _opts():
    return dict(mixed=False, tol=1e-11)


@functools.lru_cache(maxsize=None)
def _jax_forces(case):
    """jax.grad of the JAX package's energy_fn in the atom positions,
    jitted, H2O/3-21G (grid 1), tol 1e-11."""
    mol = dqc_tpu.Mol(H2O, basis="3-21G", grid=1)
    qc = (dqc_tpu.HF(mol, opts=JOptions(**_opts())) if CASES[case] is None
          else dqc_tpu.KS(mol, xc=CASES[case], opts=JOptions(**_opts())))
    p = qc._all_params()

    def e_of(pos):
        q = dict(p)
        q["basis"] = dict(p["basis"])
        q["basis"]["atompos"] = pos
        return qc.energy_fn(q)
    return -np.asarray(jax.jit(jax.grad(e_of))(p["basis"]["atompos"]))


def _port_calc(case, desc=H2O, basis="3-21G", **kw):
    mol = dqt.Mol(desc, basis=basis, grid=1, device="cpu", **kw)
    opts = SCFOptions(tol=1e-11)
    if CASES.get(case) is None:
        return mol, dqt.HF(mol, opts=opts)
    return mol, dqt.KS(mol, xc=CASES[case], opts=opts)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forces_match_jax_and_finite_differences(case):
    """Port forces (energy_grad) against jax.grad of dqc_tpu's energy_fn
    (1e-8 Ha/Bohr; both at tol 1e-11), translation invariance (|sum F|
    <= 1e-10) and a central difference of the port's own energy in one
    coordinate (h = 1e-4 Bohr, 1e-7)."""
    mol, qc = _port_calc(case)
    F = -qc.energy_grad()["basis"]["atompos"].numpy()
    assert np.abs(F - _jax_forces(case)).max() <= 1e-8
    assert np.abs(F.sum(0)).max() <= 1e-10
    h = 1e-4
    es = []
    for s in (1, -1):
        pos = mol.atompos.clone()
        pos[1, 1] += s * h
        es.append(float(_port_calc(case, (mol.atomzs, pos))[1].run()
                        .energy()))
    assert abs((es[0] - es[1]) / (2 * h) + F[1, 1]) <= 1e-7


def test_grad_in_basis_exponents_and_efield():
    """dE/d(alphas) and dE/d(efield) of HF H2/STO-3G in a field against
    central differences of the port's energy_fn (as tests/test_grads.py
    does for the JAX package; 1e-6)."""
    ef = [0.0, 0.0, 0.02]
    _, qc = _port_calc(None, H2, "sto-3g", efield=ef)
    p0 = qc._all_params()
    g = qc.energy_grad(p0)
    h = 1e-5

    def e_with(key, idx, d):
        p = {k: v for k, v in p0.items()}
        p["basis"] = dict(p0["basis"])
        if key == "efield":
            x = p0["efield"].clone()
            x[idx] += d
            p["efield"] = x
        else:
            x = p0["basis"]["alphas"][0].clone()
            x[idx] += d
            p["basis"]["alphas"] = [x] + list(p0["basis"]["alphas"][1:])
        with torch.no_grad():
            return float(qc.energy_fn(p))
    for key, idx, ad in (("efield", 2, g["efield"][2]),
                         ("alphas", (0, 0), g["basis"]["alphas"][0][0, 0]),
                         ("alphas", (0, 2), g["basis"]["alphas"][0][0, 2])):
        fd = (e_with(key, idx, h) - e_with(key, idx, -h)) / (2 * h)
        assert abs(fd - float(ad)) <= 1e-6, (key, idx, fd, float(ad))
    assert abs(float(g["efield"][2])) > 1e-3


def _benzene_desc():
    """Benzene with D6h bond lengths (C-C 1.39 A, C-H 1.09 A), atoms at
    multiples of 60 degrees in the xy plane, C and H alternating."""
    rcc = 1.39 / 0.52917721092
    rch = (1.39 + 1.09) / 0.52917721092
    atoms = []
    for i in range(6):
        a = np.pi / 3 * i
        atoms.append(f"C {rcc * np.cos(a):.10f} {rcc * np.sin(a):.10f} 0.0")
        atoms.append(f"H {rch * np.cos(a):.10f} {rch * np.sin(a):.10f} 0.0")
    return "; ".join(atoms)


def _mirror(F, axis):
    """Forces of benzene (_benzene_desc) mapped by the mirror axis -> -axis:
    atom pair k at angle 60k goes to angle 180 - 60k (x) or -60k (y)."""
    G_ = np.zeros_like(F)
    for k in range(6):
        j = (3 - k) % 6 if axis == 0 else (-k) % 6
        G_[2 * j:2 * j + 2] = F[2 * k:2 * k + 2]
        G_[2 * j:2 * j + 2, axis] *= -1
    return G_


def test_forces_keep_the_mirror_symmetry_of_benzene():
    """HF/STO-3G benzene: its orbitals (and those of S) come in degenerate
    pairs that the SCF splits by rounding. The forces keep the
    molecule's x and y mirror symmetries to 1e-10 Ha/Bohr, the adjoint
    solve needs no GMRES step (xbar = F solves it, since the energy is
    stationary in the occupied-virtual rotations), and a central
    difference of the energy in atom 2's x (h = 1e-4 Bohr, where the
    first form of the derivative was off by 0.23) agrees to 1e-8."""
    _, qc = _port_calc(None, _benzene_desc(), "sto-3g")
    F = -qc.energy_grad()["basis"]["atompos"].numpy()
    assert [r["iterations"] for r in qc.stats["gmres"]] == [0]
    for axis in (0, 1):
        assert np.abs(F - _mirror(F, axis)).max() <= 1e-10
    h = 1e-4
    p0 = qc._all_params()
    es = []
    for s in (1, -1):
        pos = p0["basis"]["atompos"].clone()
        pos[2, 0] += s * h
        with torch.no_grad():
            es.append(float(qc.energy_fn(
                dict(p0, basis=dict(p0["basis"], atompos=pos)))))
        assert qc.stats["residual"] <= 1e-11
    assert abs((es[0] - es[1]) / (2 * h) + F[2, 0]) <= 1e-8


def test_energy_hvp_matches_finite_differences_of_energy_grad():
    """energy_hvp of B3LYP H2O/3-21G (grid 1, off its mirror plane) along a
    seeded direction of the atom positions, against the central
    difference of energy_grad (h = 1e-4 Bohr, whose truncation error is
    about 6e-8 here) to 1e-6; the transposed solve of the adjoint runs."""
    desc = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0.1 -1.4309 -0.8867"
    _, qc = _port_calc("b3lyp", desc)
    qc.run()
    p0 = qc._all_params()
    pos0 = p0["basis"]["atompos"]
    d = torch.as_tensor(np.random.default_rng(3).standard_normal(pos0.shape))
    v = qc._like(p0, [None] * 64)
    v["basis"] = dict(v["basis"], atompos=d)
    hv = qc.energy_hvp(v)["basis"]["atompos"]
    assert [r["solve"] for r in qc.stats["gmres"]] == [
        "adjoint", "transposed", "adjoint"]
    h = 1e-4
    gs = [qc.energy_grad(dict(p0, basis=dict(p0["basis"],
                                             atompos=pos0 + s * h * d)))
          ["basis"]["atompos"] for s in (1, -1)]
    fd = (gs[0] - gs[1]) / (2 * h)
    assert float((hv - fd).abs().max()) <= 1e-6
    assert float(fd.abs().max()) > 0.1


def test_first_gradient_of_a_process_frees_its_calc():
    """The first energy_grad of a fresh interpreter (no import done by an
    earlier test) leaves nothing that holds its calc: with the cyclic
    garbage collector off, a weak reference to an HF H2O/STO-3G calc on
    the dense route is dead once the caller drops it. torch.utils.
    checkpoint's first call imports torch._dynamo, whose import keeps a
    frame cycle; made inside the gradient it held the caller's frames
    (ops/eri.py makes it at import time). Nor does any gradient leave a
    tensor to the cyclic collector: the HF one and a B3LYP one leave no
    tensor in gc.garbage (self-referencing closures held the Hermite R
    values of every ERI block and theta's leaves)."""
    import os
    import subprocess
    import sys
    code = "\n".join([
        "import gc, weakref",
        "gc.disable()",
        "import dqc_tpu_torch as dq",
        "mol = dq.Mol('O 0 0 0.2217; H 0 1.4309 -0.8867; "
        "H 0 -1.4309 -0.8867', basis='sto-3g', device='cpu')",
        "qc = dq.HF(mol)",
        "g = qc.energy_grad()",
        "assert qc.jk_mode == 'dense'",
        "ref = weakref.ref(qc)",
        "del qc, g",
        "print('calc alive:', ref() is not None)",
        "ks = dq.KS(dq.Mol((mol.atomzs, mol.atompos), basis='sto-3g', "
        "grid=1, device='cpu'), xc='b3lyp')",
        "g = ks.energy_grad()",
        "del ks, g, mol",
        "gc.set_debug(gc.DEBUG_SAVEALL)",
        "gc.collect()",
        "import torch",
        "print('tensors in cycles:', sum(isinstance(o, torch.Tensor) "
        "for o in gc.garbage))"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2:] == ["calc alive: False", "tensors in cycles: 0"]
