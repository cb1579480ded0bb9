"""PyTorch/CUDA port: description layer against the JAX package.

Molecule parsing, basis loading, shell packing and the pair tables of
`dqc_tpu_torch` against `dqc_tpu` on the same descriptions, on the CPU.
These are host-side numpy computations copied across, plus a few
elementwise tensor ops (`normalized_coeffs`), so the tolerance is 1e-14
(relative to values of order 1: exp/log may differ by an ulp between XLA's
and PyTorch's CPU math libraries).
"""
import importlib

import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.ops import shellstruct as jss
from dqc_tpu_torch.ops import shellstruct as tss

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TOL = 1e-14
H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
BASES = ["sto-3g", "3-21g", "def2-svp", "cc-pvdz", "6-311++g**"]
SET_MODULES = ["sto3g", "p321g", "def2svp", "ccpvdz", "p6311ppgss"]


def _close(a, b, tol=TOL):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
    assert np.abs(a - b).max() <= tol * scale if a.size else True


def _mols(basis):
    return (dqc_tpu.Mol(H2O, basis=basis),
            dqt.Mol(H2O, basis=basis, device="cpu"))


@pytest.mark.parametrize("modname", SET_MODULES)
def test_vendored_data_is_a_true_copy(modname):
    """The port keeps its own copy of the basis tables: same digits."""
    a = importlib.import_module(f"dqc_tpu.basis.sets.{modname}")
    b = importlib.import_module(f"dqc_tpu_torch.basis.sets.{modname}")
    assert a.DATA == b.DATA
    assert set(getattr(a, "NONVERBATIM", ())) == set(
        getattr(b, "NONVERBATIM", ()))


def test_sph_data_is_a_true_copy():
    from dqc_tpu.ops.sph_data import SPH_COEFFS as a
    from dqc_tpu_torch.ops.sph_data import SPH_COEFFS as b
    assert a == b


@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("elem", ["H", "O"])
@pytest.mark.parametrize("normalize", [True, False])
def test_loadbasis(basis, elem, normalize):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ja = dqc_tpu.loadbasis(f"{elem}:{basis}", normalize=normalize)
        ta = dqt.loadbasis(f"{elem}:{basis}", normalize=normalize)
    assert len(ja) == len(ta)
    for x, y in zip(ja, ta):
        assert x.angmom == y.angmom and x.normalized == y.normalized
        _close(y.alphas, x.alphas)
        _close(y.coeffs, x.coeffs)


def test_loadbasis_errors():
    with pytest.raises(ValueError):
        dqt.loadbasis("1:nonexistent-basis")
    with pytest.raises(ValueError):
        dqt.loadbasis("sto-3g")


def test_parse_gaussian94():
    text = """****
H     0
S   3   1.00
      0.3425250914D+01       0.1543289673D+00
      0.6239137298D+00       0.5353281423D+00
      0.1688554040D+00       0.4446345422D+00
****
O     0
SP   2   1.00
      5.0331513             -0.09996723             0.15591627
      1.1695961              0.39951283             0.60768372
****
"""
    from dqc_tpu.basis.loader import parse_gaussian94 as jp
    from dqc_tpu_torch.basis.loader import parse_gaussian94 as tp
    ja, ta = jp(text), tp(text)
    assert sorted(ja) == sorted(ta) == [1, 8]
    for z in ja:
        for x, y in zip(ja[z], ta[z]):
            assert x.angmom == y.angmom
            _close(y.alphas, x.alphas)
            _close(y.coeffs, x.coeffs)


@pytest.mark.parametrize("desc", [
    H2O, "H 1 0 0\nH -1 0 0",
    (["O", "H", "H"], [[0, 0, 0.2], [0, 1.4, -0.9], [0, -1.4, -0.9]])])
def test_parse_moldesc(desc):
    jz, jp = dqc_tpu.parse_moldesc(desc)
    tz, tp = dqt.parse_moldesc(desc, device="cpu")
    assert tz.dtype == torch.float64 and tp.dtype == torch.float64
    _close(tz.numpy(), jz)
    _close(tp.numpy(), jp)


def test_parse_moldesc_errors_and_units():
    with pytest.raises(ValueError):
        dqt.parse_moldesc("H 1 0", device="cpu")
    with pytest.raises(ValueError):
        dqt.parse_moldesc("Xx 0 0 0", device="cpu")
    _, jp = dqc_tpu.parse_moldesc("H 0 0 0; H 0.74 0 0", unit="angstrom")
    _, tp = dqt.parse_moldesc("H 0 0 0; H 0.74 0 0", unit="angstrom",
                              device="cpu")
    _close(tp.numpy(), jp)


@pytest.mark.parametrize("basis", BASES)
def test_pack_basis_meta(basis):
    jm, tm = _mols(basis)
    a, b = jm.meta, tm.meta
    assert (a.nao, a.nshell, a.natom) == (b.nao, b.nshell, b.natom)
    assert a.shell_loc == b.shell_loc
    assert len(a.classes) == len(b.classes)
    for ca, cb in zip(a.classes, b.classes):
        assert (ca.l, ca.kmax, ca.shell_ids, ca.atom_ids, ca.ao_starts) == (
            cb.l, cb.kmax, cb.shell_ids, cb.atom_ids, cb.ao_starts)
    assert a.max_l == b.max_l
    # frozen and hashable, as the static description has to be
    assert hash(b) == hash(tm.meta)
    with pytest.raises(Exception):
        b.nao = 3


@pytest.mark.parametrize("basis", BASES)
def test_pack_basis_params(basis):
    jm, tm = _mols(basis)
    _close(tm.params["atompos"].numpy(), jm.params["atompos"])
    for key in ("alphas", "coeffs", "mask"):
        assert len(tm.params[key]) == len(jm.params[key])
        for x, y in zip(jm.params[key], tm.params[key]):
            assert y.dtype == torch.float64
            _close(y.numpy(), x)


@pytest.mark.parametrize("basis", BASES)
def test_normalized_coeffs(basis):
    jm, tm = _mols(basis)
    for ci, cls in enumerate(jm.meta.classes):
        jc = jss.normalized_coeffs(cls.l, jm.params["alphas"][ci],
                                   jm.params["coeffs"][ci],
                                   jm.params["mask"][ci])
        tc = tss.normalized_coeffs(cls.l, tm.params["alphas"][ci],
                                   tm.params["coeffs"][ci],
                                   tm.params["mask"][ci])
        _close(tc.numpy(), jc)


@pytest.mark.parametrize("basis", ["sto-3g", "3-21g", "def2-svp"])
def test_pair_tables(basis):
    """Unique shell-pair lists (the JAX package plans them in C++; the port
    in numpy) and the AO scatter indices."""
    jm, tm = _mols(basis)
    jp, tp = jss.tri_pair_classes(jm.meta), tss.tri_pair_classes(tm.meta)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        assert (a.ca, a.cb, a.npair) == (b.ca, b.cb, b.npair)
        assert np.array_equal(np.asarray(a.ia), b.ia)
        assert np.array_equal(np.asarray(a.ib), b.ib)
        ja = np.asarray(jss.pair_ao_indices(jm.meta, a), dtype=np.int64)
        ta = tss.pair_ao_indices(tm.meta, b)
        assert ta.dtype == np.int64 and np.array_equal(ja, ta)
        gi_j = jss.gather_pair_inputs(jm.meta, jm.params, a)
        gi_t = tss.gather_pair_inputs(tm.meta, tm.params, b)
        for key in ("A", "B", "aa", "ab", "ca", "cb"):
            _close(gi_t[key].numpy(), gi_j[key])
        assert (gi_j["la"], gi_j["lb"]) == (gi_t["la"], gi_t["lb"])


@pytest.mark.parametrize("kw", [
    dict(), dict(charge=1), dict(spin=2), dict(charge=-1, spin=1)])
def test_electrons_and_occupations(kw):
    jm = dqc_tpu.Mol(H2O, basis="sto-3g", **kw)
    tm = dqt.Mol(H2O, basis="sto-3g", device="cpu", **kw)
    assert jm.nelec == tm.nelec and jm.polarized == tm.polarized
    assert jm.spin == tm.spin
    jw, tw = jm.get_orb_weights(), tm.get_orb_weights()
    if tm.polarized:
        assert isinstance(tw, dqt.SpinParam)
        _close(tw.u.numpy(), jw.u)
        _close(tw.d.numpy(), jw.d)
    else:
        _close(tw.numpy(), jw)
    jw, tw = jm.get_orb_weights(True), tm.get_orb_weights(True)
    _close(tw.u.numpy(), jw.u)
    _close(tw.d.numpy(), jw.d)


def test_mol_probes_and_hooks_not_ported_yet():
    with pytest.raises(ValueError):
        dqt.Mol("Xx 0 0 0", device="cpu")
    m = dqt.Mol(H2O, basis="sto-3g", device="cpu")
    # the on-disk theta cache is ported: set_cache returns the molecule
    assert m.set_cache("x") is m and m._cache_fname == "x"
    assert m.cache_signature == dqc_tpu.Mol(H2O,
                                            basis="sto-3g").cache_signature
    assert m.dfinfo is None
    assert m.densityfit() is m and m.dfinfo.method == "coulomb"
    assert m.setup_grid() is m.setup_grid()          # built once
    # the grid-tabulated external potential is a differentiable input
    ng = m.setup_grid().w0.shape[0]
    mv = dqt.Mol(H2O, basis="sto-3g", device="cpu", vext=np.zeros(ng))
    assert tuple(dqt.HF(mv)._all_params()["vext"].shape) == (ng,)
    for name in ("hessian_pos", "edipole", "ValGrad", "Sol",
                 "band_energies"):
        assert callable(getattr(dqt, name))
    with pytest.raises(AttributeError):
        dqt.no_such_name
    assert dqt.__version__ == dqc_tpu.__version__


def test_atompos_tensor_is_kept():
    """A position tensor the caller owns is kept as given, not detached."""
    pos = torch.tensor([[0.0, 0, 0], [1.4, 0, 0]], dtype=torch.float64,
                       requires_grad=True)
    m = dqt.Mol((["H", "H"], pos), basis="sto-3g", device="cpu")
    assert m.params["atompos"] is pos
    e = m.get_nuclei_energy()
    (g,) = torch.autograd.grad(e, pos)
    np.testing.assert_allclose(g[0, 0].item(), 1.0 / 1.4 ** 2, rtol=1e-12)
    _close(e.item(), float(dqc_tpu.Mol("H 0 0 0; H 1.4 0 0",
                                       basis="sto-3g").get_nuclei_energy()))
