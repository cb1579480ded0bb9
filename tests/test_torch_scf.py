"""PyTorch/CUDA port: the SCF spine against the JAX package, on the CPU.

One JAX Hartree-Fock run on H2O/STO-3G gives `theta` (the integrals), a
converged density and the energy; `theta_from_numpy` carries theta across,
and each stage of the port's engine is held against the JAX engine on the
same seeded inputs. Tolerances: 1e-10 for single stages (float64 matrix
products and one eigensolve of a 7x7 matrix, values of order 1 to 10;
LAPACK and XLA order their sums differently), 1e-9 Ha for converged energies
(both sides stop at a residual of 1e-8, and the energy error is quadratic in
it). Eigenvectors are never compared: their signs and the basis inside
degenerate subspaces differ between solvers. `dm`, eigenvalues, `X X^T` and
energies are.
"""
import functools
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.scf import engine as jengine
from dqc_tpu.scf import fixed_point as jfp
from dqc_tpu.scf import orth as jorth
from dqc_tpu_torch.convert import theta_from_numpy
from dqc_tpu_torch.scf import engine as tengine
from dqc_tpu_torch.scf import fixed_point as tfp
from dqc_tpu_torch.scf import orth as torth
from dqc_tpu_torch.scf import qccalc as tqc

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TOL = 1e-10
H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
H2 = "H -0.5 0 0; H 0.5 0 0"
THETA_KEYS = ("hcore", "ovlp", "X", "keep", "enuc", "occ", "eri")


@functools.lru_cache(maxsize=None)
def _jax_run(desc, basis):
    """JAX HF (no f32 warm phase) -> (calc, theta as numpy)."""
    mol = dqc_tpu.Mol(desc, basis=basis)
    qc = dqc_tpu.HF(mol, opts=jfp.SCFOptions(mixed=False)).run()
    theta_np = {k: np.asarray(qc._theta[k]) for k in THETA_KEYS}
    return qc, theta_np


def _thetas(polarized):
    """(JAX theta, port theta) of H2O/STO-3G from the same numbers."""
    _, theta_np = _jax_run(H2O, "sto-3g")
    theta_np = dict(theta_np)
    if polarized:
        theta_np["occ"] = np.stack([theta_np["occ"] / 2] * 2)
    jt = {k: jnp.asarray(v) for k, v in theta_np.items()}
    tt = theta_from_numpy(theta_np, device="cpu")
    return jt, tt


def _seeded_dm(n, polarized, seed=11):
    rng = np.random.default_rng(seed)
    shape = (2, n, n) if polarized else (n, n)
    a = rng.standard_normal(shape) * 0.3
    return a + np.swapaxes(a, -1, -2)


def _maxdiff(t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    return float(np.abs(t - j).max())


def test_theta_from_numpy_layouts():
    _, theta_np = _jax_run(H2O, "sto-3g")
    tt = theta_from_numpy(theta_np, device="cpu")
    assert "eri" not in tt and tt["eri_k"].is_contiguous()
    assert tt["keep"].dtype == torch.bool
    assert all(v.dtype == torch.float64 for k, v in tt.items() if k != "keep")
    # eri_k[i,j,k,l] = (ik|jl)
    assert _maxdiff(tt["eri_k"], theta_np["eri"].transpose(0, 2, 1, 3)) == 0.0
    again = theta_from_numpy({"eri_k": tt["eri_k"].numpy()}, device="cpu")
    assert torch.equal(again["eri_k"], tt["eri_k"])


def test_port_theta_matches_jax_theta():
    """The port's own integrals and orthogonaliser against the JAX theta."""
    _, theta_np = _jax_run(H2O, "sto-3g")
    calc = dqt.HF(dqt.Mol(H2O, basis="sto-3g", device="cpu"))
    tt = calc._build_theta(calc._all_params())
    for key in ("hcore", "ovlp", "enuc", "occ"):
        assert _maxdiff(tt[key], theta_np[key]) <= TOL
    assert _maxdiff(tt["eri_k"],
                    theta_np["eri"].transpose(0, 2, 1, 3)) <= TOL
    assert np.array_equal(tt["keep"].numpy(), theta_np["keep"])
    assert _maxdiff(tt["X"] @ tt["X"].T,
                    theta_np["X"] @ theta_np["X"].T) <= TOL


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("stage", ["jk_parts", "fock", "dm_from_fock",
                                   "diis_err", "energy", "step"])
def test_engine_stage(stage, polarized):
    jt, tt = _thetas(polarized)
    n = tt["hcore"].shape[0]
    dm_np = _seeded_dm(n, polarized)
    jdm, tdm = jnp.asarray(dm_np), torch.as_tensor(dm_np)
    je = jengine.HFEngine(polarized=polarized)
    te = tengine.HFEngine(polarized=polarized)
    if stage == "jk_parts":
        jj, jk = je.jk_parts(jdm, jt)
        tj, tk = te.jk_parts(tdm, tt)
        assert _maxdiff(tj, jj) <= TOL and _maxdiff(tk, jk) <= TOL
        assert _maxdiff(te._j(tt, te.dm_tot(tdm)), jj) <= TOL
        assert _maxdiff(te._k(tt, tdm), jk) <= TOL
    elif stage == "fock":
        assert _maxdiff(te.fock(tdm, tt), je.fock(jdm, jt)) <= TOL
    elif stage == "dm_from_fock":
        jf = je.fock(jdm, jt)
        tf = torch.tensor(np.asarray(jf))
        assert _maxdiff(te.dm_from_fock(tf, tt),
                        je.dm_from_fock(jf, jt)) <= TOL
        # eigenvalues too; never the eigenvectors
        _, jw, _ = jengine.orthogonal_fock_to_dm(jf, jt["X"], jt["keep"],
                                                 jt["occ"])
        _, tw, _ = tengine.orthogonal_fock_to_dm(tf, tt["X"], tt["keep"],
                                                 tt["occ"])
        assert _maxdiff(tw, jw) <= TOL
    elif stage == "diis_err":
        jf = je.fock(jdm, jt)
        tf = torch.tensor(np.asarray(jf))
        assert _maxdiff(te.diis_err(tf, tdm, tt),
                        je.diis_err(jf, jdm, jt)) <= TOL
    elif stage == "energy":
        assert _maxdiff(te.energy(tdm, tt), je.energy(jdm, jt)) <= TOL
        jj, jk = je.jk_parts(jdm, jt)
        tj, tk = te.jk_parts(tdm, tt)
        assert _maxdiff(te.energy_from_parts(tdm, tj, tk, tt),
                        je.energy_from_parts(jdm, jj, jk, jt)) <= TOL
    else:
        assert _maxdiff(te.step(tdm, tt), je.step(jdm, jt)) <= TOL


@pytest.mark.parametrize("case", ["h2o", "near_singular"])
def test_orthogonalizer(case):
    if case == "h2o":
        s = _jax_run(H2O, "sto-3g")[1]["ovlp"]
        n_masked = 0
    else:
        # an overcomplete basis: one direction below the cutoff is masked
        rng = np.random.default_rng(5)
        q, _ = np.linalg.qr(rng.standard_normal((8, 8)))
        w = np.array([1e-12, 1e-3, 0.05, 0.3, 0.8, 1.0, 1.7, 2.5])
        s = (q * w) @ q.T
        s = 0.5 * (s + s.T)
        n_masked = 1
    jx, jkeep = jorth.orthogonalizer(jnp.asarray(s))
    tx, tkeep = torth.orthogonalizer(torch.tensor(s))
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert int((~tkeep).sum()) == n_masked
    jxx = np.asarray(jx) @ np.asarray(jx).T
    txx = (tx @ tx.T).numpy()
    assert np.abs(txx - jxx).max() <= TOL * np.abs(jxx).max()
    assert torth.LARGE == jorth.LARGE


def test_eigh_needs_no_polish_on_cpu():
    """The JAX package polishes eigenvectors (a no-op on CPU LAPACK); the
    port's safe_eigh is torch.linalg.eigh: same spectrum, tiny residual."""
    from dqc_tpu.scf.eigh import safe_eigh as jeigh
    from dqc_tpu_torch.scf.eigh import safe_eigh as teigh
    rng = np.random.default_rng(9)
    a = rng.standard_normal((30, 30))
    a = a + a.T
    jw, _ = jeigh(jnp.asarray(a))
    tw, tv = teigh(torch.as_tensor(a))
    assert _maxdiff(tw, jw) <= 1e-12
    at = torch.as_tensor(a)
    assert (at @ tv - tv * tw[None, :]).abs().max().item() <= 1e-12


def test_scf_options_match():
    assert tfp.SCFOptions._fields == jfp.SCFOptions._fields
    assert tfp.SCFOptions._field_defaults == jfp.SCFOptions._field_defaults


def _synthetic_map(xp, m, b):
    """A contraction with a mild nonlinearity: f -> M f + b + 0.1 sin f,
    error vector = step(f) - f."""
    def step_and_err(f):
        f_new = m @ f + b + 0.1 * xp.sin(f)
        return f_new, f_new - f
    return step_and_err


@pytest.mark.parametrize("optkw", [
    dict(), dict(tol=1e-12), dict(damping=0.3), dict(diis_start=4),
    dict(diis_size=4), dict(maxiter=7),
    dict(tol=0.0, diis_patience=3, maxiter=60)],
    ids=["default", "tight", "damping", "late_start", "short_history",
         "maxiter_exit", "patience_exit"])
def test_diis_solve_synthetic(optkw):
    """Same map, same start, same options through both loops: iteration
    count, best residual and the residual history agree. The history is
    compared to 1e-6 relative while it is above 1e-9: below that it is
    rounding noise amplified by a nearly singular DIIS matrix."""
    rng = np.random.default_rng(21)
    d = 24
    m = rng.standard_normal((d, d))
    m = 0.7 * m / np.abs(np.linalg.eigvals(m)).max()
    b = rng.standard_normal(d)
    f0 = rng.standard_normal(d)
    jout = jfp.diis_solve(_synthetic_map(jnp, jnp.asarray(m), jnp.asarray(b)),
                          jnp.asarray(f0), jfp.SCFOptions(**optkw))
    tout = tfp.diis_solve(
        _synthetic_map(torch, torch.as_tensor(m), torch.as_tensor(b)),
        torch.as_tensor(f0), tfp.SCFOptions(**optkw))
    jh, th = np.asarray(jout[4]), tout[4].numpy()
    big = np.isfinite(jh) & (jh > 1e-9)
    assert big.sum() >= 5
    np.testing.assert_allclose(th[big], jh[big], rtol=1e-6)
    if "tol" not in optkw or optkw["tol"] >= 1e-9:
        assert int(tout[2]) == int(jout[2])
        assert np.array_equal(np.isnan(th), np.isnan(jh))
        np.testing.assert_allclose(tout[3], float(jout[3]), rtol=1e-5)
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   atol=1e-7)
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                                   atol=1e-7)
    else:
        assert abs(int(tout[2]) - int(jout[2])) <= 2


def test_diis_solve_freezes_on_non_finite():
    """A non-finite iterate never becomes the best one. As in the JAX loop it
    poisons the history: the loop falls back to the best input again and
    again, stops improving, and leaves through the patience exit with the
    best iterate seen before."""
    calls = {"n": 0}

    def step_and_err(f):
        calls["n"] += 1
        f_new = 0.5 * torch.roll(f, 1) + torch.arange(3, dtype=f.dtype)
        if calls["n"] == 3:
            f_new = f_new * float("nan")
        return f_new, f_new - f

    opts = tfp.SCFOptions(maxiter=40, diis_patience=5)
    f_in, f_raw, n_iter, best_err, errh = tfp.diis_solve(
        step_and_err, torch.zeros(3, dtype=torch.float64), opts)
    assert torch.isfinite(f_in).all() and torch.isfinite(f_raw).all()
    assert np.isfinite(best_err) and best_err == errh[1].item()
    assert torch.isinf(errh[2]) or torch.isnan(errh[2])
    assert n_iter == 1 + opts.diis_patience + 1     # best_it = 1


def test_diis_solve_on_h2o_matches_jax():
    """The SCF map of H2O/STO-3G from the core guess through both loops:
    same iteration count, same residual history (1e-4 relative above 1e-7;
    the tail below is eigensolver rounding), same converged Fock matrix."""
    jt, tt = _thetas(False)
    je, te = jengine.HFEngine(), tengine.HFEngine()

    def jstep(f):
        dm = je.dm_from_fock(f, jt)
        f_new = je.fock(dm, jt)
        return f_new, je.diis_err(f_new, dm, jt)

    def tstep(f):
        dm = te.dm_from_fock(f, tt)
        f_new = te.fock(dm, tt)
        return f_new, te.diis_err(f_new, dm, tt)

    opts = dict(tol=1e-8)
    jout = jfp.diis_solve(jstep, jt["hcore"], jfp.SCFOptions(**opts))
    tout = tfp.diis_solve(tstep, tt["hcore"], tfp.SCFOptions(**opts))
    assert int(tout[2]) == int(jout[2])
    jh, th = np.asarray(jout[4]), tout[4].numpy()
    big = np.isfinite(jh) & (jh > 1e-7)
    np.testing.assert_allclose(th[big], jh[big], rtol=1e-4)
    assert tout[3] <= 1e-8 and float(jout[3]) <= 1e-8
    assert _maxdiff(tout[0], jout[0]) <= 1e-7


@pytest.mark.parametrize("desc,basis", [(H2, "3-21G"), (H2O, "sto-3g")],
                         ids=["h2-321g", "h2o-sto3g"])
def test_hf_energy_matches_jax(desc, basis):
    """End to end: dqc_tpu_torch.HF against dqc_tpu.HF."""
    jqc, _ = _jax_run(desc, basis)
    tq = dqt.HF(dqt.Mol(desc, basis=basis, device="cpu")).run()
    assert abs(float(tq.energy()) - float(jqc.energy())) <= 1e-9
    assert tq.stats["residual"] <= tq.opts.tol
    # density matrices agree to the square root of the energy agreement
    assert _maxdiff(tq.aodm(), jqc.aodm()) <= 1e-6
    assert abs(float(tq.dm2energy(tq.aodm())) - float(tq.energy())) <= 1e-12
    assert tengine.ds_jk_kplanes.__module__ == "dqc_tpu_torch.ops.hopper_jk"


@pytest.mark.parametrize("desc,anchor,tol", [
    (H2, -1.07195346, 1e-6),
    ("Li -2.5 0 0; Li 2.5 0 0", -14.7683688, 1e-6),
    ("C -1.0 0 0; O 1.0 0 0", -112.078732, 1e-5)],
    ids=["h2", "li2", "co"])
def test_rhf_anchor(desc, anchor, tol):
    """PySCF RHF/3-21G energies (BASELINE.md), with the tolerances the JAX
    package's own tests use."""
    qc = dqt.HF(dqt.Mol(desc, basis="3-21G", device="cpu")).run()
    assert abs(float(qc.energy()) - anchor) < tol


def test_uhf_of_a_closed_shell_equals_rhf():
    mol = dqt.Mol(H2O, basis="sto-3g", device="cpu")
    r = dqt.HF(mol).run()
    u = dqt.HF(mol, restricted=False).run()
    assert abs(float(r.energy()) - float(u.energy())) <= 1e-9
    dm = u.aodm()
    assert isinstance(dm, dqt.SpinParam)
    assert _maxdiff(dm.u + dm.d, r.aodm().numpy()) <= 1e-6
    s = r._theta["ovlp"]
    assert abs(torch.einsum("ij,ji->", r.aodm(), s).item() - 10.0) <= 1e-10
    assert abs(float(u.dm2energy(dm)) - float(u.energy())) <= 1e-12


def test_uhf_doublet_runs_and_lies_below_the_cation_guess():
    """An open shell: OH radical, spin 1. Polarized path end to end."""
    mol = dqt.Mol("O 0 0 0; H 0 0 1.8", basis="sto-3g", device="cpu")
    assert mol.polarized
    qc = dqt.HF(mol).run()
    dm = qc.aodm()
    s = qc._theta["ovlp"]
    assert abs(torch.einsum("ij,ji->", dm.u, s).item() - 5.0) <= 1e-10
    assert abs(torch.einsum("ij,ji->", dm.d, s).item() - 4.0) <= 1e-10
    assert qc.stats["residual"] <= 1e-8
    assert -75.0 < float(qc.energy()) < -74.0


def test_gwh_start_reaches_the_same_energy(monkeypatch):
    """Above GUESS_NAO the port starts from the GWH Fock where the JAX
    package takes SAD; the converged energy does not depend on the start."""
    mol = dqt.Mol(H2O, basis="sto-3g", device="cpu")
    core = dqt.HF(mol).run()
    monkeypatch.setattr(tqc, "GUESS_NAO", 0)
    gwh = dqt.HF(mol).run()
    assert abs(float(core.energy()) - float(gwh.energy())) <= 1e-9
    th = core._theta
    f = tqc.gwh_fock(th, False).numpy()
    h, s = th["hcore"].numpy(), th["ovlp"].numpy()
    d = np.diagonal(h)
    ref = 0.5 * 1.75 * (d[:, None] + d[None, :]) * s
    np.fill_diagonal(ref, d)
    assert np.abs(f - ref).max() <= 1e-14
    assert tqc.gwh_fock(th, True).shape == (2, 7, 7)
    with pytest.raises(ValueError):
        dqt.HF(mol, opts=dqt.SCFOptions(guess="nonsense"))


def test_field_couplings_enter_hcore():
    """Mol(efield=..., efield_grad=...) reaches hcore through the multipole
    integrals (held against JAX in test_torch_integrals.py):
    H' = E.r + (1/2) sum G_de x_d x_e."""
    from dqc_tpu_torch.ops import integrals as tint
    ef = [0.01, 0.0, -0.02]
    eg = [[0.0, 0.003, 0.0], [0.003, 0.0, 0.0], [0.0, 0.0, 0.001]]
    m0 = dqt.Mol(H2, basis="3-21G", device="cpu")
    m1 = dqt.Mol(H2, basis="3-21G", device="cpu", efield=ef, efield_grad=eg)
    c0, c1 = dqt.HF(m0), dqt.HF(m1)
    h0 = c0._build_theta(c0._all_params())["hcore"]
    h1 = c1._build_theta(c1._all_params())["hcore"]
    mp = lambda pw: tint.multipole(m0.meta, m0.params, pw)
    want = (h0 + ef[0] * mp((1, 0, 0)) + ef[2] * mp((0, 0, 1))
            + 0.5 * (2 * eg[0][1] * mp((1, 1, 0)) + eg[2][2] * mp((0, 0, 2))))
    assert _maxdiff(h1, want.numpy()) <= 1e-13
    e0, e1 = float(c0.run().energy()), float(c1.run().energy())
    assert 1e-7 < abs(e1 - e0) < 1e-2


def test_routes_not_ported_yet_raise(monkeypatch):
    """The variational mode is taken (variational=True or the option) and an
    unknown SCF method raises; past the dense limit HF takes the blocked
    route, and the streamed one past the blocked limit."""
    mol = dqt.Mol(H2, basis="sto-3g", device="cpu")
    assert dqt.HF(mol, variational=True).opts.method == "variational"
    assert dqt.HF(mol, opts=dqt.SCFOptions(
        method="variational")).opts.method == "variational"
    with pytest.raises(ValueError, match="unknown SCF method"):
        dqt.HF(mol, opts=dqt.SCFOptions(method="newton"))
    monkeypatch.setattr(tqc.config, "DENSE_ERI_BYTES_LIMIT", 100)
    assert dqt.HF(mol).jk_mode == "blocked"
    monkeypatch.setattr(tqc.config, "BLOCKED_JK_BYTES_LIMIT", 0)
    assert dqt.HF(mol).jk_mode == "stream"


def test_no_silent_cpu():
    """Without a CUDA device and without device="cpu" the entry points
    raise; they never carry on on the CPU by themselves."""
    if torch.cuda.is_available():
        assert dqt.Mol(H2, basis="sto-3g").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dqt.Mol(H2, basis="sto-3g")
    with pytest.raises(RuntimeError):
        dqt.Mol(H2, basis="sto-3g", device="cuda")
    with pytest.raises(RuntimeError):
        dqt.parse_moldesc(H2)
    from dqc_tpu_torch.convert import params_from_numpy
    with pytest.raises(RuntimeError):
        params_from_numpy({"atompos": np.zeros((1, 3)), "alphas": [],
                           "coeffs": [], "mask": []})


def test_import_leaves_jax_out():
    """`import dqc_tpu_torch`, and every module of it, pulls in neither jax
    nor the JAX package."""
    code = ("import sys, pkgutil, importlib; import dqc_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "dqc_tpu_torch.__path__, 'dqc_tpu_torch.')]; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'dqc_tpu' or "
            "m.startswith('dqc_tpu.') or m.startswith('jaxlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
