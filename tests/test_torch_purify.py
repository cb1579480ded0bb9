"""PyTorch/CUDA port: canonical purification (scf/purify.py) against the
JAX package's, and against the port's eigh route, on the CPU.

Seeded orthogonal-frame Fock matrices: purify_orth within 1e-12 of the JAX
function (the same polynomial in the same order; the products round
differently), and fock_to_dm_purify within 1e-10 of
engine.orthogonal_fock_to_dm (the tests/test_purify.py gate), restricted,
polarized and with masked orthogonaliser directions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqc_tpu.scf import purify as jpur
from dqc_tpu_torch.scf import purify as tpur
from dqc_tpu_torch.scf.engine import orthogonal_fock_to_dm
from dqc_tpu_torch.scf.orth import orthogonalizer

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port


def _spd(n, rng, cond=30.0):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.geomspace(1.0 / cond, 1.0, n)) @ q.T


def _occ(n, nocc, f):
    occ = np.zeros(n)
    occ[:nocc] = f
    return occ


@pytest.mark.parametrize("n,nocc,seed", [(24, 7, 0), (13, 5, 1), (9, 1, 2)])
def test_purify_orth_matches_jax(n, nocc, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, n))
    f = 0.5 * (f + f.T)
    d = tpur.purify_orth(torch.as_tensor(f), nocc).numpy()
    jd = np.asarray(jpur.purify_orth(jnp.asarray(f), nocc, iters=96))
    np.testing.assert_allclose(d, jd, atol=1e-12)
    assert abs(np.trace(d) - nocc) < 1e-10
    np.testing.assert_allclose(d @ d, d, atol=1e-10)


def test_fock_to_dm_purify_matches_eigh_and_jax():
    rng = np.random.default_rng(3)
    n = 18
    s = torch.as_tensor(_spd(n, rng))
    X, keep = orthogonalizer(s)
    f = rng.standard_normal((2, n, n))
    fock = torch.as_tensor(0.5 * (f + np.swapaxes(f, -1, -2)))
    for occ in (torch.as_tensor(_occ(n, 6, 2.0)),
                torch.as_tensor(np.stack([_occ(n, 5, 1.0),
                                          _occ(n, 4, 1.0)]))):
        fk = fock[0] if occ.ndim == 1 else fock
        dm_e, _, _ = orthogonal_fock_to_dm(fk, X, keep, occ)
        dm_p = tpur.fock_to_dm_purify(fk, X, keep, occ)
        np.testing.assert_allclose(dm_p.numpy(), dm_e.numpy(), atol=1e-10)
        jdm = jpur.fock_to_dm_purify(jnp.asarray(fk.numpy()),
                                     jnp.asarray(X.numpy()),
                                     jnp.asarray(keep.numpy()),
                                     jnp.asarray(occ.numpy()), iters=96)
        np.testing.assert_allclose(dm_p.numpy(), np.asarray(jdm), atol=1e-12)


def test_purify_with_masked_directions():
    """A near-singular overlap: the dropped orthogonaliser columns stay
    empty (pinned above the spectrum), as on the eigh route."""
    rng = np.random.default_rng(4)
    n = 12
    s = _spd(n, rng, cond=1e12)
    X, keep = orthogonalizer(torch.as_tensor(s))
    assert not bool(keep.all())
    f = rng.standard_normal((n, n))
    fock = torch.as_tensor(0.5 * (f + f.T))
    occ = torch.as_tensor(_occ(n, 4, 2.0))
    dm_e, _, _ = orthogonal_fock_to_dm(fock, X, keep, occ)
    dm_p = tpur.fock_to_dm_purify(fock, X, keep, occ)
    np.testing.assert_allclose(dm_p.numpy(), dm_e.numpy(), atol=1e-10)
