"""PyTorch/CUDA port: the on-disk theta cache (utils/cache.py,
Mol/Sol.set_cache), the cache signature and the angular-rule tag against
the JAX package, on the CPU.

- Cache semantics as tests/test_system.py holds the JAX package's: a second
  call serves the stored array, a fresh Cache on the same file reads it,
  another signature (or, in the port, another fingerprint) warns and
  recomputes; paramnames and add_prefix; tensors come back bit for bit.
- cache_signature equals the JAX package's string for the same molecule
  and cell; angular_rule_tag is "leb" in both (the JAX package's default).
- A KS run with set_cache writes theta's parts; a second run loads them
  (theta_cached names them, no eri_s), with the same energy bit for bit,
  and energy_grad after the cached run equals the uncached one bit for bit
  (derivatives rebuild theta from the params). A cell caches its theta as
  one part, "all".
"""
import os

import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.grid import angular as jang
from dqc_tpu_torch.grid import angular as tang
from dqc_tpu_torch.utils.cache import Cache

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"


def test_cache_roundtrip(tmp_path):
    f = str(tmp_path / "t.npz")
    c = Cache(f, signature="sig1")
    calls = []

    def compute():
        calls.append(1)
        return torch.arange(9, dtype=torch.float64).reshape(3, 3) / 7.0

    a = c.cache("m", compute)
    b = c.cache("m", compute)
    assert len(calls) == 1 and torch.equal(a, b)
    d = Cache(f, signature="sig1").cache("m", compute)   # from the file
    assert len(calls) == 1 and torch.equal(a, d)
    with pytest.warns(UserWarning):
        Cache(f, signature="other").cache("m", compute)
    assert len(calls) == 2
    with pytest.warns(UserWarning):
        Cache(f, signature="sig1", fingerprint="x").cache("m", compute)
    assert len(calls) == 3


def test_cache_paramnames_prefix_and_trees(tmp_path):
    f = str(tmp_path / "t.npz")
    c = Cache(f, signature="s", paramnames=["theta/core"])
    sub = c.add_prefix("theta")
    calls = []

    def tree():
        calls.append(1)
        return {"x": torch.ones(2), "d": {"k": torch.zeros(3, dtype=bool)},
                "n": 4, "none": None}
    t1 = sub.cache_tree("core", tree)
    t2 = Cache(f, signature="s", paramnames=["core"]).add_prefix(
        "theta").cache_tree("core", tree)
    assert len(calls) == 1
    assert torch.equal(t1["x"], t2["x"]) and t2["n"] == 4
    assert t2["none"] is None and t2["d"]["k"].dtype == torch.bool
    sub.cache_tree("grid", tree)                   # not a cached part
    assert len(calls) == 2 and not sub.has_tree("grid")
    assert Cache.get_dummy().cache("m", lambda: 1) == 1


def test_signatures_and_angular_tag_match_jax():
    assert tang.angular_rule_tag() == jang.angular_rule_tag() == "leb"
    p, w = tang.angular_grid_by_precision(17)
    jp, jw = jang.angular_grid_by_precision(17)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(w, jw)
    for desc, kw in ((H2O, {"basis": "3-21G", "grid": 1}),
                     ("N 0 0 0; N 0 0 2.07", {"basis": "sto-3g",
                                              "charge": 1, "spin": 1})):
        assert (dqt.Mol(desc, device="cpu", **kw).cache_signature
                == dqc_tpu.Mol(desc, **kw).cache_signature)
    lat = np.eye(3) * 4.0
    ts = dqt.Sol("H 0 0 0; H 1.4 0 0", lat, basis="sto-3g", device="cpu")
    js = dqc_tpu.Sol("H 0 0 0; H 1.4 0 0", lat, basis="sto-3g")
    assert ts.cache_signature == js.cache_signature
    other = dqt.Sol("H 0 0 0; H 1.4 0 0", lat, basis="3-21G", device="cpu")
    assert other.cache_signature == ts.cache_signature
    assert other.cache_fingerprint != ts.cache_fingerprint


def test_set_cache_serves_theta_and_keeps_the_bits(tmp_path):
    f = str(tmp_path / "theta.npz")

    def calc(cache=True):
        mol = dqt.Mol(H2O, basis="sto-3g", grid=0, device="cpu")
        if cache:
            assert mol.set_cache(f) is mol
        return dqt.KS(mol, xc="b3lyp").run()
    a = calc()
    assert os.path.exists(f) and a.stats["theta_cached"] == []
    b = calc()
    assert b.stats["theta_cached"] == ["core", "grid"]
    assert "eri_s" not in b.stats and "eri_s" in a.stats
    assert torch.equal(a.energy(), b.energy())
    ref = calc(cache=False)
    gb, gr = b.energy_grad(), ref.energy_grad()
    assert torch.equal(gb["basis"]["atompos"], gr["basis"]["atompos"])
    assert float(gr["basis"]["atompos"].abs().max()) > 1e-3


def test_paramnames_limit_the_parts(tmp_path):
    f = str(tmp_path / "t.npz")
    for _ in range(2):
        mol = dqt.Mol(H2O, basis="sto-3g", grid=0, device="cpu")
        qc = dqt.KS(mol.set_cache(f, paramnames=["grid"]), xc="lda_x").run()
    assert qc.stats["theta_cached"] == ["grid"] and "eri_s" in qc.stats


def test_cell_caches_its_theta_whole(tmp_path):
    f = str(tmp_path / "cell.npz")
    es = []
    for _ in range(2):
        sol = dqt.Sol("H 0 0 0; H 1.4 0 0", np.eye(3) * 4.0, basis="sto-3g",
                      device="cpu").set_cache(f)
        qc = dqt.HF(sol).run()
        es.append(qc.energy())
    assert qc.stats["theta_cached"] == ["all"]
    assert torch.equal(es[0], es[1])
