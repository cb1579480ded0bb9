"""PyTorch/CUDA port: the integration grid and the AO tables against the JAX
package on the same inputs, on the CPU.

GridSpec building is numpy on both sides and must agree to the last bit
(the port reads its own copy of the Lebedev tables). Becke weights and the
AO tables are float64 torch against float64 jnp: the same formulas with
exp, sqrt and pow from different math libraries, so a few ulp of values of
order 1 remain; the tolerance is 1e-12 absolute (AO values are at most
about 10, the Becke weights at most 1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.grid import factory as jfactory
from dqc_tpu.grid import lebedev as jleb
from dqc_tpu.ops import aoeval as jaoeval
from dqc_tpu.xc import integrate as jint
from dqc_tpu_torch.convert import params_from_numpy
from dqc_tpu_torch.grid import factory as tfactory
from dqc_tpu_torch.grid import lebedev as tleb
from dqc_tpu_torch.ops import aoeval as taoeval
from dqc_tpu_torch.xc import integrate as tint

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
_BENZ_Z = [6, 1] * 6
GRIDS = {
    "benzene-2": (_BENZ_Z, 2),
    "h2o-sg3": ([8, 1, 1], "sg3"),
    "h2o-sg2": ([8, 1, 1], "sg2"),
    "h2o-1": ([8, 1, 1], 1),
    "lif-3": ([3, 9], 3),
}


@functools.lru_cache(maxsize=None)
def _mols(basis, grid=1):
    """(JAX Mol, port Mol on the CPU, port params from the JAX params)."""
    jm = dqc_tpu.Mol(H2O, basis=basis, grid=grid)
    tm = dqt.Mol(H2O, basis=basis, grid=grid, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                               device="cpu")
    return jm, tm, params


@pytest.mark.parametrize("prec", tleb.LEBEDEV_PRECISIONS)
def test_lebedev_tables_are_a_true_copy(prec):
    """The port reads its own copy of every table, with the same numbers."""
    assert tleb._DATA_DIR != jleb._DATA_DIR
    tp, tw = tleb.lebedev_grid(prec)
    jp, jw = jleb.lebedev_grid(prec)
    assert np.array_equal(tp, jp) and np.array_equal(tw, jw)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_gridspec_matches_jax(name):
    zs, level = GRIDS[name]
    t = tfactory.get_predefined_grid(level, zs)
    j = jfactory.get_predefined_grid(level, zs, np.zeros((len(zs), 3)))
    assert t.ngrid == j.ngrid
    for key in ("ratom", "dirs", "w0", "atom_idx", "atom_radii"):
        assert np.array_equal(getattr(t, key), getattr(j, key)), key


def test_benzene_grid_level_2_size():
    """The main path's grid: 78,144 points from the Lebedev rules of degree
    9 and 17 only (the level-2 pruning of C and H)."""
    t = tfactory.get_predefined_grid(2, _BENZ_Z)
    assert t.ngrid == 78144
    sizes = {len(tleb.lebedev_by_degree(d)[1]) for d in (9, 17)}
    assert sizes == {38, 110}


def test_grid_refuses_unknown_names():
    with pytest.raises(ValueError):
        tfactory.get_predefined_grid("sg9", [1])


@pytest.mark.parametrize("level", [1, "sg3"])
def test_becke_weights_and_dvol_match_jax(level):
    jm, tm, params = _mols("3-21G", level)
    grid = tm.setup_grid()
    jt = jint.setup_grid_theta(jm.meta, jm.params, jm.setup_grid(), family=1)
    tt = tint.setup_grid_theta(tm.meta, params, grid, family=1)
    for key in ("coords", "dvol"):
        diff = np.abs(tt[key].numpy() - np.asarray(jt[key])).max()
        assert diff <= 1e-12, (key, diff)


@pytest.mark.parametrize("basis", ["3-21G", "def2-svp"])
@pytest.mark.parametrize("deriv", [0, 1, 2])
def test_eval_ao_matches_jax(basis, deriv):
    """Values, gradients and laplacians on a few hundred points around the
    molecule (def2-SVP has d shells on O)."""
    jm, tm, params = _mols(basis)
    rng = np.random.default_rng(deriv)
    coords = rng.normal(scale=1.5, size=(300, 3))
    j = jaoeval.eval_ao(jm.meta, jm.params, jnp.asarray(coords), deriv=deriv)
    t = taoeval.eval_ao(tm.meta, params, torch.as_tensor(coords), deriv=deriv)
    assert sorted(t) == sorted(j)
    for key in t:
        assert t[key].shape == j[key].shape
        diff = np.abs(t[key].numpy() - np.asarray(j[key])).max()
        assert diff <= 1e-12, (key, diff)


def test_setup_grid_theta_tables_match_jax():
    """The tables of a GGA, ao_grad in the (3, ng, nao) layout of both
    packages, through the port's chunked evaluation."""
    jm, tm, params = _mols("3-21G")
    jt = jint.setup_grid_theta(jm.meta, jm.params, jm.setup_grid(), family=2)
    old = tint.AO_EVAL_CHUNK
    tint.AO_EVAL_CHUNK = 1000     # several chunks and a short last one
    try:
        tt = tint.setup_grid_theta(tm.meta, params, tm.setup_grid(), family=2)
    finally:
        tint.AO_EVAL_CHUNK = old
    assert tt["ao_grad"].shape == (3, 6604, 13) and tt["ao_grad"].is_contiguous()
    for key in ("ao", "ao_grad"):
        diff = np.abs(tt[key].numpy() - np.asarray(jt[key])).max()
        assert diff <= 1e-12, (key, diff)


def test_electron_count_on_the_grid_matches_jax():
    """sum_g dvol rho(g) of one density matrix (a converged KS density of
    H2O/3-21G) on each package's own grid and tables: the two agree to
    1e-12 and both give the 10 electrons to the accuracy of grid level 1."""
    jm, tm, params = _mols("3-21G")
    dm = dqt.KS(tm, xc="lda_x").run().aodm().numpy()
    jt = jint.setup_grid_theta(jm.meta, jm.params, jm.setup_grid(), family=1)
    tt = tint.setup_grid_theta(tm.meta, params, tm.setup_grid(), family=1)
    jr = jint.density_from_tables(jt, jnp.asarray(dm), 1, False)["rho"]
    tr = tint.density_from_tables(tt, torch.as_tensor(dm), 1, False)["rho"]
    jn = float(jnp.sum(jt["dvol"] * jr))
    tn = float(torch.sum(tt["dvol"] * tr))
    assert abs(tn - jn) <= 1e-12
    assert abs(tn - 10.0) <= 1e-3
