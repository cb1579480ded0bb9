"""PyTorch/CUDA port: Boys function and molecular integrals against the JAX
package on the same numpy inputs, on the CPU.

The JAX functions run eagerly (no jit: compiling the whole integral program
costs minutes). Both sides do the same recursions in float64; sums are taken
in another order (einsum paths, scatter order) and exp/erf come from
different math libraries, so a few ulp of the largest intermediate remain:
the tolerance is 1e-11 absolute on values of order 1 to 100 (1e-13 for the
Boys function itself, whose values are at most 1).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.ops import boys as jboys
from dqc_tpu.ops import eri as jeri
from dqc_tpu.ops import integrals as jint
from dqc_tpu_torch.convert import params_from_numpy
from dqc_tpu_torch.ops import boys as tboys
from dqc_tpu_torch.ops import eri as teri
from dqc_tpu_torch.ops import integrals as tint

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TOL = 1e-11
MOLS = {
    # minimal basis, s and p shells
    "h2o-sto3g": ("O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867",
                  "sto-3g"),
    # a d shell (oxygen in def2-SVP), contracted s and p shells
    "oh-def2svp": ("O 0 0 0; H 0.3 -0.2 1.8", "def2-svp"),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX Mol, port meta, port params made from the JAX params as numpy)."""
    desc, basis = MOLS[name]
    jm = dqc_tpu.Mol(desc, basis=basis)
    tm = dqt.Mol(desc, basis=basis, device="cpu")
    params_np = jax.tree_util.tree_map(np.asarray, jm.params)
    return jm, tm.meta, params_from_numpy(params_np, device="cpu")


def _maxdiff(t, j):
    t = t.detach().numpy()
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == np.float64
    return float(np.abs(t - j).max())


@pytest.mark.parametrize("mmax", [0, 1, 2, 4, 8])
def test_boys(mmax):
    """Sweep through both branches and their join at T = 27."""
    T = np.concatenate([
        [0.0, 1e-14, 1e-8, 1e-3], np.linspace(0.01, 26.99, 150),
        [26.999999, 27.0, 27.000001], np.linspace(27.01, 80.0, 60),
        [150.0, 1e3, 1e5]])
    j = np.asarray(jboys.boys(jax.numpy.asarray(T), mmax))
    t = tboys.boys(torch.as_tensor(T), mmax).numpy()
    assert t.shape == (T.size, mmax + 1)
    assert np.all(np.isfinite(t))
    assert np.abs(t - j).max() <= 1e-13
    # F_0(0) = 1 and F_m(0) = 1/(2m+1)
    np.testing.assert_allclose(t[0], 1.0 / (2 * np.arange(mmax + 1) + 1),
                               rtol=1e-14)
    lst = tboys.boys_list(torch.as_tensor(T.reshape(4, -1)), mmax)
    assert len(lst) == mmax + 1 and lst[0].shape == (4, T.size // 4)


ONE_ELECTRON = {
    "overlap": lambda I, meta, p, z: I.overlap(meta, p),
    "kinetic": lambda I, meta, p, z: I.kinetic(meta, p),
    "nuclattr": lambda I, meta, p, z: I.nuclattr(meta, p, z),
    "rinv": lambda I, meta, p, z: I.rinv(meta, p, [0.1, -0.2, 0.3]),
    "dipole_x": lambda I, meta, p, z: I.multipole(meta, p, (1, 0, 0)),
    "quadrupole_yz": lambda I, meta, p, z: I.multipole(
        meta, p, (0, 1, 1), [0.0, 0.1, -0.1]),
}


@pytest.mark.parametrize("what", sorted(ONE_ELECTRON))
def test_one_electron_h2o_sto3g(what):
    jm, tmeta, tparams = _pair("h2o-sto3g")
    fn = ONE_ELECTRON[what]
    j = fn(jint, jm.meta, jm.params, jm.atomzs)
    t = fn(tint, tmeta, tparams, torch.tensor(np.asarray(jm.atomzs)))
    assert _maxdiff(t, j) <= TOL
    assert _maxdiff(t, t.T) <= 1e-13


@pytest.mark.parametrize("what", ["overlap", "kinetic", "nuclattr"])
def test_one_electron_d_shell(what):
    jm, tmeta, tparams = _pair("oh-def2svp")
    assert tmeta.max_l == 2
    fn = ONE_ELECTRON[what]
    j = fn(jint, jm.meta, jm.params, jm.atomzs)
    t = fn(tint, tmeta, tparams, torch.tensor(np.asarray(jm.atomzs)))
    assert _maxdiff(t, j) <= TOL


def test_canonical_values_h2_sto3g():
    """Textbook values (Szabo & Ostlund) of H2/STO-3G at R = 1.4 a0."""
    m = dqt.Mol("H 0 0 0; H 1.4 0 0", basis="sto-3g", device="cpu")
    S = tint.overlap(m.meta, m.params)
    T = tint.kinetic(m.meta, m.params)
    G = teri.eri_dense(m.meta, m.params)
    assert abs(S[0, 1].item() - 0.6593) < 1e-4
    assert abs(T[0, 0].item() - 0.7600) < 1e-4
    assert abs(G[0, 0, 0, 0].item() - 0.7746) < 1e-4
    assert abs(G[0, 1, 0, 1].item() - 0.2970) < 1e-4


def test_eri_dense_h2o_sto3g():
    jm, tmeta, tparams = _pair("h2o-sto3g")
    j = jeri.eri_dense(jm.meta, jm.params)
    t = teri.eri_dense(tmeta, tparams)
    assert _maxdiff(t, j) <= TOL
    # the 8-fold symmetry of (ij|kl)
    assert _maxdiff(t, t.permute(1, 0, 2, 3)) <= 1e-13
    assert _maxdiff(t, t.permute(2, 3, 0, 1)) <= 1e-13
    # a block of two bra rows at a time gives the same tensor as one block
    t2 = teri.eri_dense(tmeta, tparams, block=2)
    assert _maxdiff(t2, t) <= 1e-13


def test_eri_dense_screened_h2o_sto3g():
    """Schwarz bounds, the pruned pair lists, and the tensor built from
    them. A stretched geometry, so that the screen really drops pairs."""
    desc = "O 0 0 0; H 0 0 1.8; H 0 0 14.0"
    jm = dqc_tpu.Mol(desc, basis="sto-3g")
    tm = dqt.Mol(desc, basis="sto-3g", device="cpu")
    jq = jeri.schwarz_bounds(jm.meta, jm.params)
    tq = teri.schwarz_bounds(tm.meta, tm.params)
    for a, b in zip(jq, tq):
        assert _maxdiff(b, a) <= TOL
    thresh = 1e-6
    jscr = jeri.screened_pair_classes(jm.meta, jm.params, thresh=thresh)
    tscr = teri.screened_pair_classes(tm.meta, tm.params, thresh=thresh)
    dropped = 0
    for (jpc, jqk), (tpc, tqk), q in zip(jscr, tscr, tq):
        assert np.array_equal(np.asarray(jpc.ia), tpc.ia)
        assert np.array_equal(np.asarray(jpc.ib), tpc.ib)
        assert np.abs(np.asarray(jqk) - tqk).max() <= TOL
        dropped += q.shape[0] - tpc.npair
    assert dropped > 0
    j = jeri.eri_dense(jm.meta, jm.params, screened=jscr, thresh=thresh)
    t = teri.eri_dense(tm.meta, tm.params, screened=tscr, thresh=thresh)
    assert _maxdiff(t, j) <= TOL
    full = teri.eri_dense(tm.meta, tm.params)
    assert 0.0 < _maxdiff(t, full) <= 10 * thresh


def test_eri_dense_d_shell():
    jm, tmeta, tparams = _pair("oh-def2svp")
    j = jeri.eri_dense(jm.meta, jm.params)
    t = teri.eri_dense(tmeta, tparams)
    assert t.shape == (19, 19, 19, 19)
    assert _maxdiff(t, j) <= TOL


@pytest.mark.parametrize("name", sorted(MOLS))
def test_scatter_indices_are_unique_per_call(name):
    """eri_dense adds each quartet group with one index_add, which uses
    atomics on a CUDA device. Inside one call no flat index repeats (a
    shell-pair quartet owns its AO block), so the order of the adds cannot
    change a sum and the tensor repeats bit for bit; the same holds for the
    one-electron assembly."""
    from dqc_tpu_torch.ops.shellstruct import (pair_ao_indices,
                                               tri_pair_classes)
    _, tmeta, _ = _pair(name)
    n2 = tmeta.nao ** 2
    pcs = tri_pair_classes(tmeta)
    idxs = [pair_ao_indices(tmeta, pc).reshape(pc.npair, -1) for pc in pcs]
    for a in idxs:
        assert np.unique(a).size == a.size
    for gi in range(len(pcs)):
        for gj in range(gi, len(pcs)):
            flat = (idxs[gi][:, :, None, None] * n2
                    + idxs[gj][None, None, :, :]).ravel()
            assert np.unique(flat).size == flat.size


def test_eri_long_range_kernel_limits():
    """The erf(omega r)/r kernel of coulomb_contract, which eri_dense hands
    through (range-separated hybrids use it later): it tends to 1/r for
    large omega, is dominated by 1/r, and grows with omega."""
    tm = dqt.Mol("H 0 0 0; H 1.4 0 0", basis="3-21g", device="cpu")
    full = teri.eri_dense(tm.meta, tm.params)
    lr_big = teri.eri_dense(tm.meta, tm.params, omega=1e4)
    lr_a = teri.eri_dense(tm.meta, tm.params, omega=0.4)
    lr_b = teri.eri_dense(tm.meta, tm.params, omega=0.8)
    assert _maxdiff(lr_big, full) <= 1e-6
    d = torch.arange(4)
    diag = lambda g: g[d[:, None], d[:, None], d[None, :], d[None, :]]
    assert (diag(lr_a) < diag(lr_b)).all() and (diag(lr_b) < diag(full)).all()


def test_integrals_differentiate():
    """Plain autograd passes through the integral code (no in-place writes
    into tensors that depend on the parameters): d<S>/dR against a central
    finite difference."""
    def s01(x):
        pos = torch.stack([torch.zeros(3, dtype=torch.float64),
                           torch.stack([x, x.new_zeros(()), x.new_zeros(())])])
        m = dqt.Mol((["H", "H"], pos), basis="3-21g", device="cpu")
        g = teri.eri_dense(m.meta, m.params)
        return tint.overlap(m.meta, m.params)[0, 2] + g[0, 1, 2, 3]

    x = torch.tensor(1.4, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(s01(x), x)
    h = 1e-5
    with torch.no_grad():
        fd = (s01(x + h) - s01(x - h)) / (2 * h)
    assert abs(g.item() - fd.item()) < 1e-8
