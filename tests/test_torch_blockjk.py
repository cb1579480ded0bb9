"""PyTorch/CUDA port: the exact J/K routes past the dense limit (scf/jk.py),
against the JAX package, on the CPU.

The same molecules go through both packages (H2O and the Li atom in 3-21G,
as in tests/test_jk.py; nao 13 and 9), and the same seeded numpy density
matrices:
  - build_jk_meta (also on a Schwarz-screened pair list),
    build_jk_factors, jk_combos and jk_blocks_nbytes: exact, or 1e-13
    relative for the factors.
  - the weighted canonical block of every combo (build_jk_block,
    _combo_block): 1e-12 relative to its largest entry.
  - _combo_contract of every combo and _jk_symmetrize, jk_from_blocks,
    _combo_jk and jk_matrices: J and K of a symmetric dm (H2O) and K of a
    spin-stacked one (Li): 1e-11 abs.
  - the blocked and streamed branches of HFEngine/KSEngine.jk_parts: 1e-11.
  - the route choice with BLOCKED_JK_BYTES_LIMIT against the JAX package's
    _jk_setup under the same limits.
  - blocked (H2O) and streamed (H2) HF energies against the JAX package's
    (its byte limits lowered with monkeypatch, its expansion to eri_k
    turned off): 1e-9 Ha; its streamed run goes through the host-driven
    solver, whose RI phase and dual-level polish the port's _stream_solve
    follows.
  - blocked RKS-PBE (J only), B3LYP and UHF against the port's dense route:
    1e-10 Ha; the streamed solver's records and its exit rule.
  - blocked forces against jax.grad of the JAX package's energy_fn in
    blocked mode (H2), and blocked and streamed forces against the port's
    dense forces (H2O): 1e-9.
  - a range-separated hybrid past the dense limit raises in both packages,
    the port's error naming mol.densityfit().
Each JAX result is computed once per process (lru_cache).
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
from dqc_tpu.scf import jk as jjk
from dqc_tpu.scf import qccalc as jqc
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu.xc import get_xc as jget_xc
from dqc_tpu_torch.ops import eri as teri
from dqc_tpu_torch.scf import engine as tengine
from dqc_tpu_torch.scf import jk as tjk
from dqc_tpu_torch.scf import qccalc as tqc
from dqc_tpu_torch.xc import getxc as tgetxc

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
LI = "Li 0 0 0"
H2 = "H 0 0 0; H 0 0 1.4"
CASES = {"h2o": (H2O, 0), "li": (LI, 1)}
TIGHT = 1e-11
ENGINE_XC = (None, "b3lyp", "pbe")


def _mols(case):
    desc, spin = CASES[case]
    return (dqc_tpu.Mol(desc, basis="3-21G", spin=spin),
            dqt.Mol(desc, basis="3-21G", spin=spin, device="cpu"))


def _dm(case, nao):
    """Seeded symmetric dm: (nao, nao) for H2O, spin-stacked for Li."""
    rng = np.random.default_rng(3)
    d = rng.standard_normal((2, nao, nao))
    d = d + d.transpose(0, 2, 1)
    return d[0] if case == "h2o" else d


@functools.lru_cache(maxsize=None)
def _jax_jk(case):
    """The JAX package's blocks, raw per-combo contractions, J/K from the
    blocks and from the stream, and (H2O) its engines' jk_parts on a blocked
    and a streamed theta, at the seeded dm (one jit)."""
    jm, _ = _mols(case)
    meta = jm.meta
    jkm = jjk.build_jk_meta(meta)
    combos = jjk.jk_combos(jkm)
    dm = jnp.asarray(_dm(case, meta.nao))

    def run(params, dm):
        blocks = [jjk.build_jk_block(meta, params, jkm, ci)
                  for ci in range(len(combos))]
        pol = dm.ndim == 3
        dmt = dm.sum(axis=0) if pol else dm
        dmk = dm if pol else dm[None]
        raw = [jjk._combo_contract(meta.nao, jkm[gi], jkm[gj], blocks[ci],
                                   dmt, dmk, True, True)
               for ci, (gi, gj) in enumerate(combos)]
        facs = jjk.build_jk_factors(meta, params, jkm)
        out = {"blocks": blocks, "raw": raw,
               "facs": [(f.H, f.p, f.P) for f in facs],
               "from_blocks": jjk.jk_from_blocks(meta, jkm, blocks, dm),
               "stream": jjk.jk_matrices(meta, jkm, facs, dm)}
        if not pol:
            thetas = {"blocked": {f"jkb{i}": b for i, b in enumerate(blocks)},
                      "stream": {"jk_facs": facs}}
            for xc in ENGINE_XC:
                eng = (jengine.HFEngine(jk_info=(meta, jkm)) if xc is None
                       else jengine.KSEngine(jget_xc(xc),
                                             jk_info=(meta, jkm)))
                for mode, th in thetas.items():
                    out[f"engine_{mode}_{xc}"] = eng.jk_parts(dm, th)
        return out
    out = jax.jit(run)(jm.params, dm)
    return jax.tree_util.tree_map(np.asarray, out), jkm


def _np(t):
    return t.detach().numpy()


def _maxabs(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max())


# --- the static plan, the factors and the blocks -----------------------------

@pytest.mark.parametrize("screened", [False, True])
def test_jk_meta_combos_and_bytes(screened):
    """The same pair groups, AO starts, diagonal weights, combo order and
    block bytes; on Schwarz-screened pair lists (H2O and an H2 30 Bohr away:
    the pairs across the gap drop out), both packages' build_jk_meta given
    the same screened list."""
    if screened:
        desc = H2O + "; H 0 0 30; H 0 0 31.4"
        jm = dqc_tpu.Mol(desc, basis="3-21G")
        tm = dqt.Mol(desc, basis="3-21G", device="cpu")
        scr = teri.screened_pair_classes(tm.meta, tm.params)
        assert sum(pc.npair for pc, _ in scr) < sum(
            pc.npair for pc in teri.tri_pair_classes(tm.meta))
        jkm = jjk.build_jk_meta(jm.meta, scr)
        tkm = tjk.build_jk_meta(tm.meta, scr)
    else:
        jm, tm = _mols("h2o")
        jkm, tkm = jjk.build_jk_meta(jm.meta), tjk.build_jk_meta(tm.meta)
    jkm = [g for g in jkm if len(g["row0"])]   # the port drops empty groups
    assert len(jkm) == len(tkm)
    for j, t in zip(jkm, tkm):
        assert (j["sa"], j["sb"]) == (t["sa"], t["sb"])
        for key in ("row0", "col0", "w"):
            assert np.array_equal(np.asarray(j[key]), t[key]), key
        assert np.array_equal(j["pc"].ia, t["pc"].ia)
        assert np.array_equal(j["pc"].ib, t["pc"].ib)
    assert tjk.jk_combos(tkm) == jjk.jk_combos(jkm)
    assert tjk.jk_blocks_nbytes(tkm) == jjk.jk_blocks_nbytes(jkm)


def test_jk_factors_match():
    """build_jk_factors: the Hermite factors of every pair group."""
    out, _ = _jax_jk("h2o")
    _, tm = _mols("h2o")
    facs = tjk.build_jk_factors(tm.meta, tm.params, tjk.build_jk_meta(tm.meta))
    assert len(facs) == len(out["facs"])
    for f, (H, p, P) in zip(facs, out["facs"]):
        for a, b in ((f.H, H), (f.p, p), (f.P, P)):
            assert _maxabs(_np(a), b) <= 1e-13 * max(np.abs(b).max(), 1.0)
    # theta's form gives the same factors back
    back = tjk.theta_factors({"jk_facs": tjk.factors_to_theta(facs)},
                             tjk.build_jk_meta(tm.meta))
    assert all(torch.equal(a.H, b.H) and a.L == b.L
               for a, b in zip(back, facs))


def test_combo_blocks_match():
    """build_jk_block / _combo_block of every combo, and build_jk_blocks
    (the blocked theta's entries, from one set of factors): 1e-12
    relative."""
    out, _ = _jax_jk("h2o")
    _, tm = _mols("h2o")
    tkm = tjk.build_jk_meta(tm.meta)
    every = tjk.build_jk_blocks(tm.meta, tm.params, tkm)
    assert len(every) == len(out["blocks"])
    for ci, ref in enumerate(out["blocks"]):
        blk = tjk.build_jk_block(tm.meta, tm.params, tkm, ci)
        assert _maxabs(_np(blk), ref) <= 1e-12 * np.abs(ref).max(), ci
        assert torch.equal(blk, every[ci])


# --- the contractions --------------------------------------------------------

def _port_jk(case):
    _, tm = _mols(case)
    tkm = tjk.build_jk_meta(tm.meta)
    blocks = [tjk.build_jk_block(tm.meta, tm.params, tkm, ci)
              for ci in range(len(tjk.jk_combos(tkm)))]
    return tm, tkm, blocks, torch.as_tensor(_dm(case, tm.meta.nao))


@pytest.mark.parametrize("case", ["h2o", "li"])
def test_combo_contract_and_symmetrize(case):
    """The raw contractions of every combo (J's two sides, K's four
    pairings) and the symmetrisation: 1e-11 abs."""
    out, _ = _jax_jk(case)
    tm, tkm, blocks, dm = _port_jk(case)
    nao = tm.meta.nao
    pol = dm.ndim == 3
    dmt = dm.sum(0) if pol else dm
    dmk = dm if pol else dm[None]
    jflat = torch.zeros(nao * nao, dtype=torch.float64)
    kacc = torch.zeros((dmk.shape[0], nao, nao), dtype=torch.float64)
    for ci, (gi, gj) in enumerate(tjk.jk_combos(tkm)):
        ja, ka = tjk._combo_contract(nao, tkm[gi], tkm[gj], blocks[ci], dmt,
                                     dmk, True, True)
        assert _maxabs(_np(ja), out["raw"][ci][0]) <= TIGHT
        assert _maxabs(_np(ka), out["raw"][ci][1]) <= TIGHT
        jflat, kacc = jflat + ja, kacc + ka
    jref = sum(r[0] for r in out["raw"])
    kref = sum(r[1] for r in out["raw"])
    js, ks = jjk._jk_symmetrize(jnp.asarray(jref), jnp.asarray(kref), nao,
                                pol, True, True)
    jt, kt = tjk._jk_symmetrize(jflat, kacc, nao, pol, True, True)
    assert _maxabs(_np(jt), js) <= TIGHT and _maxabs(_np(kt), ks) <= TIGHT


@pytest.mark.parametrize("case", ["h2o", "li"])
def test_jk_from_blocks_and_jk_matrices(case):
    """J and K from the cached blocks and from the stream (_combo_jk per
    combo), on H2O's symmetric dm and Li's spin-stacked one: 1e-11 abs; J
    only and K only give the same matrices."""
    out, _ = _jax_jk(case)
    tm, tkm, blocks, dm = _port_jk(case)
    facs = tjk.build_jk_factors(tm.meta, tm.params, tkm)
    jb, kb = tjk.jk_from_blocks(tm.meta, tkm, blocks, dm)
    js, ks = tjk.jk_matrices(tm.meta, tkm, facs, dm)
    for (j, k), key in (((jb, kb), "from_blocks"), ((js, ks), "stream")):
        assert _maxabs(_np(j), out[key][0]) <= TIGHT, key
        assert _maxabs(_np(k), out[key][1]) <= TIGHT, key
    j_only, none = tjk.jk_from_blocks(tm.meta, tkm, blocks, dm, want_k=False)
    assert none is None and torch.equal(j_only, jb)
    none, k_only = tjk.jk_matrices(tm.meta, tkm, facs, dm, want_j=False)
    assert none is None and torch.equal(k_only, ks)
    nao = tm.meta.nao
    pol = dm.ndim == 3
    ja, ka = tjk._combo_jk(nao, tkm[0], tkm[1], False, facs[0], facs[1],
                           dm.sum(0) if pol else dm, dm if pol else dm[None],
                           True, True)
    ci = tjk.jk_combos(tkm).index((0, 1))
    assert _maxabs(_np(ja), out["raw"][ci][0]) <= TIGHT
    assert _maxabs(_np(ka), out["raw"][ci][1]) <= TIGHT


@pytest.mark.parametrize("xc", ENGINE_XC)
@pytest.mark.parametrize("mode", ["blocked", "stream"])
def test_engine_branches(mode, xc):
    """HFEngine/KSEngine.jk_parts on a blocked theta (jkb{i}) and a streamed
    one (jk_facs) against the JAX engines' at the same dm: 1e-11; a
    functional without exact exchange builds no K in either package."""
    out, _ = _jax_jk("h2o")
    tm, tkm, blocks, dm = _port_jk("h2o")
    if mode == "blocked":
        tth = {f"jkb{i}": b for i, b in enumerate(blocks)}
    else:
        tth = {"jk_facs": tjk.factors_to_theta(
            tjk.build_jk_factors(tm.meta, tm.params, tkm))}
    teng = (tengine.HFEngine(jk_info=(tm.meta, tkm)) if xc is None
            else tengine.KSEngine(tgetxc.get_xc(xc), jk_info=(tm.meta, tkm)))
    jt, kt = teng.jk_parts(dm, tth)
    jj, kj = out[f"engine_{mode}_{xc}"]
    assert _maxabs(_np(jt), jj) <= TIGHT
    if xc == "pbe":
        assert kt is None and kj is None
    else:
        assert _maxabs(_np(kt), kj) <= TIGHT


# --- the route choice --------------------------------------------------------

def test_route_choice_matches_jax(monkeypatch):
    """With the dense limit below the molecule, both packages take the
    blocked route while the blocks fit BLOCKED_JK_BYTES_LIMIT and stream one
    byte below it; theta and stats hold what each route builds."""
    jm, tm = _mols("h2o")
    nbytes = tjk.jk_blocks_nbytes(tjk.build_jk_meta(tm.meta))
    monkeypatch.setattr(jqc, "DENSE_ERI_BYTES_LIMIT", 0)
    monkeypatch.setattr(tqc.config, "DENSE_ERI_BYTES_LIMIT", 0)
    for limit, mode in ((nbytes, "blocked"), (nbytes - 1, "stream")):
        monkeypatch.setattr(jqc, "BLOCKED_JK_BYTES_LIMIT", limit)
        monkeypatch.setattr(tqc.config, "BLOCKED_JK_BYTES_LIMIT", limit)
        assert jqc._jk_setup(jm, None)[0] == mode
        qc = dqt.HF(tm)
        assert qc.jk_mode == mode
        stats = {}
        th = qc._build_theta(qc._all_params(), stats=stats)
        assert stats["jk_mode"] == mode and "eri_k" not in th
        assert "eri_s" not in stats and stats["jk_blocks_bytes"] == nbytes
        assert stats["jk_combos"] == 6
        if mode == "blocked":
            assert sorted(k for k in th if k.startswith("jkb")) == [
                f"jkb{i}" for i in range(6)]
            assert stats["jk_blocks_s"] >= 0.0
        else:
            assert set(th["jk_facs"]) == {str(i) for i in range(3)}
            assert not th["warm_df"]["B"].requires_grad
            assert stats["warm_naux"] == th["warm_df"]["B"].shape[1]
            assert stats["jk_facs_s"] >= 0.0 and stats["warm_df_s"] >= 0.0


def test_range_separation_past_the_dense_limit_raises(monkeypatch):
    """CAM-B3LYP whose two dense tensors do not fit: both packages refuse
    the blocked route; the port's error names mol.densityfit()."""
    jm, tm = _mols("h2o")
    monkeypatch.setattr(jqc, "DENSE_ERI_BYTES_LIMIT", 0)
    monkeypatch.setattr(tqc.config, "DENSE_ERI_BYTES_LIMIT",
                        tm.meta.nao ** 4 * 8)
    with pytest.raises(NotImplementedError, match="densityfit"):
        dqc_tpu.KS(dqc_tpu.Mol(H2O, basis="3-21G", grid=1), xc="camb3lyp")
    with pytest.raises(NotImplementedError, match=r"mol\.densityfit\(\)"):
        dqt.KS(dqt.Mol(H2O, basis="3-21G", grid=1, device="cpu"),
               xc="camb3lyp")


# --- SCF energies ------------------------------------------------------------

def _port_calc(monkeypatch, mode, xc=None, spin=0, tol=TIGHT, desc=H2O):
    """A port HF/KS calc on `mode`'s route (byte limits set with
    monkeypatch)."""
    dense = {"dense": 16 * 1024 ** 3}.get(mode, 0)
    blocked = {"stream": 0}.get(mode, 32 * 1024 ** 3)
    monkeypatch.setattr(tqc.config, "DENSE_ERI_BYTES_LIMIT", dense)
    monkeypatch.setattr(tqc.config, "BLOCKED_JK_BYTES_LIMIT", blocked)
    mol = dqt.Mol(desc, basis="3-21G", spin=spin, grid=1, device="cpu")
    opts = dqt.SCFOptions(tol=tol)
    qc = (dqt.HF(mol, opts=opts) if xc is None
          else dqt.KS(mol, xc=xc, opts=opts))
    assert qc.jk_mode == mode
    return qc


@functools.lru_cache(maxsize=None)
def _jax_hf_energy(mode, desc):
    """The JAX package's HF energy on `mode`'s route: its dense limit 0, its
    blocked limit 0 for the stream, no expansion to eri_k; the stream
    through its host-driven solver (RI phase, dual-level polish)."""
    saved = (jqc.DENSE_ERI_BYTES_LIMIT, jqc.BLOCKED_JK_BYTES_LIMIT,
             jqc.EXPAND_K_BYTES_LIMIT, jqc.SCF_QCCalc.HOST_LOOP_NAO)
    try:
        jqc.DENSE_ERI_BYTES_LIMIT = 0
        jqc.EXPAND_K_BYTES_LIMIT = 0
        jqc.BLOCKED_JK_BYTES_LIMIT = 0 if mode == "stream" else 2 ** 40
        if mode == "stream":
            jqc.SCF_QCCalc.HOST_LOOP_NAO = 1
        mol = dqc_tpu.Mol(desc, basis="3-21G")
        qc = dqc_tpu.HF(mol, opts=JOptions(mixed=False, tol=TIGHT)).run()
        return float(qc.energy())
    finally:
        (jqc.DENSE_ERI_BYTES_LIMIT, jqc.BLOCKED_JK_BYTES_LIMIT,
         jqc.EXPAND_K_BYTES_LIMIT, jqc.SCF_QCCalc.HOST_LOOP_NAO) = saved


@pytest.mark.parametrize("mode,desc", [("blocked", H2O), ("stream", H2)])
def test_hf_energy_matches_jax(monkeypatch, mode, desc):
    """Blocked HF on H2O/3-21G and streamed HF on H2/3-21G (one pair group:
    the JAX package's host-driven solver compiles one module per combo):
    1e-9 Ha from the JAX package's run on the same route."""
    qc = _port_calc(monkeypatch, mode, desc=desc).run()
    assert abs(float(qc.energy()) - _jax_hf_energy(mode, desc)) <= 1e-9
    if mode == "stream":
        assert qc.stats["ri_iterations"] > 0


@pytest.mark.parametrize("xc,spin", [("pbe", 0), ("b3lyp", 0), (None, 2)])
def test_blocked_matches_the_dense_route(monkeypatch, xc, spin):
    """Blocked RKS-PBE (J only), B3LYP and UHF (triplet H2O) against the
    port's dense route: 1e-10 Ha; the same number of iterations."""
    qb = _port_calc(monkeypatch, "blocked", xc, spin).run()
    qd = _port_calc(monkeypatch, "dense", xc, spin).run()
    assert abs(float(qb.energy()) - float(qd.energy())) <= 1e-10
    assert qb.stats["iterations"] == qd.stats["iterations"]
    if spin:
        assert qb.aodm().u.shape == (qb.mol.meta.nao,) * 2


def test_stream_solver_records_and_exit_rule(monkeypatch):
    """The streamed SCF (B3LYP): an RI phase, then exact builds that stop at
    tol or on stagnation (a residual above 0.25 of the best); the energy
    comes from the exact J/K in hand (no exact build after the solve) and
    equals the dense route's to 1e-9 Ha."""
    calls = []
    orig = tengine.jk_matrices

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(tengine, "jk_matrices", counted)
    qc = _port_calc(monkeypatch, "stream", "b3lyp", tol=1e-8).run()
    st = qc.stats
    ex = st["exact_jk"]
    assert st["ri_iterations"] > 0 and ex["builds"] == len(ex["seconds"])
    assert len(calls) == ex["builds"]
    res = ex["residuals"]
    assert st["residual"] == min(res)
    assert res[-1] < 1e-8 or res[-1] > 0.25 * min(res[:-1])
    assert len(st["dual_inner_iterations"]) == ex["builds"] - 1
    assert st["iterations"] == (st["ri_iterations"]
                                + sum(st["dual_inner_iterations"])
                                + ex["builds"])
    qd = _port_calc(monkeypatch, "dense", "b3lyp", tol=1e-8).run()
    assert abs(float(qc.energy()) - float(qd.energy())) <= 1e-9


# --- forces ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_blocked_grad():
    """jax.grad of the JAX package's HF energy_fn of H2/3-21G in blocked
    mode (atom positions; H2 keeps the jitted gradient's compile short)."""
    saved = (jqc.DENSE_ERI_BYTES_LIMIT, jqc.EXPAND_K_BYTES_LIMIT)
    try:
        jqc.DENSE_ERI_BYTES_LIMIT = 0
        jqc.EXPAND_K_BYTES_LIMIT = 0
        qc = dqc_tpu.HF(dqc_tpu.Mol(H2, basis="3-21G"),
                        opts=JOptions(mixed=False, tol=TIGHT))
        assert "jkb0" in qc._theta_parts
        g = jax.jit(jax.grad(qc.energy_fn))(qc._all_params())
        return np.asarray(g["basis"]["atompos"])
    finally:
        jqc.DENSE_ERI_BYTES_LIMIT, jqc.EXPAND_K_BYTES_LIMIT = saved


def test_blocked_forces_match_jax_grad(monkeypatch):
    """The blocked route's energy_grad in atompos (H2/3-21G) against
    jax.grad of the JAX package's blocked energy_fn: 1e-9."""
    g = _port_calc(monkeypatch, "blocked", desc=H2).energy_grad()
    assert _maxabs(_np(g["basis"]["atompos"]), _jax_blocked_grad()) <= 1e-9


@pytest.mark.parametrize("mode", ["blocked", "stream"])
def test_forces_match_the_dense_route(monkeypatch, mode):
    """The blocked and streamed routes' energy_grad on H2O/3-21G (the
    streamed route's implicit step is the exact stream J/K) against the
    port's dense forces: 1e-9."""
    gs = _port_calc(monkeypatch, mode).energy_grad()
    gd = _port_calc(monkeypatch, "dense").energy_grad()
    assert _maxabs(_np(gs["basis"]["atompos"]),
                   _np(gd["basis"]["atompos"])) <= 1e-9
