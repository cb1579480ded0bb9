"""PyTorch/CUDA port: the fused J+K contraction (ops/hopper_jk.py) against
the JAX package's kernel module (ops/pallas_jk.py), on the CPU.

On a CPU tensor the port's wrapper `ds_jk` takes the plain PyTorch version
`ds_jk_reference`; the CUDA kernel itself is held against that same plain
version on the card (chip_smoke.py, tests/test_torch_card.py). Here the
plain version is compared with
  - the JAX oracle `ds_jk_reference` on hi/lo f32 planes from `ds_planes`:
    the planes carry the tensor to 2^-48 relative (double-single), so 1e-12
    relative to the largest output;
  - the Pallas kernel in interpret mode: the interpreter evaluates the f32
    chain in excess precision and rounds once to f32 at the output store
    (tests/test_pallas_jk.py explains), so 1e-5 relative is all it allows;
  - np.einsum in float64: 1e-12 relative (another summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqc_tpu.ops import pallas_jk
from dqc_tpu_torch.ops import hopper_jk

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port


def _eri_like(n, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n, n, n)) * np.exp(
        rng.uniform(-8, 1, (n, n, n, n)))
    # physical (ij|kl) symmetries so the J/K contraction identities hold
    t = t + t.transpose(1, 0, 2, 3)
    t = t + t.transpose(0, 1, 3, 2)
    t = t + t.transpose(2, 3, 0, 1)
    return t


def _dm(n, seed, symmetric=True):
    rng = np.random.default_rng(seed)
    dm = rng.standard_normal((n, n))
    return dm + dm.T if symmetric else dm


def _rel(a, ref):
    return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())


@pytest.fixture(autouse=True)
def _count_stays_zero():
    """The launch counter counts launches of the CUDA kernel and nothing
    else: on the CPU it never moves."""
    hopper_jk.ds_jk.launches = 0
    yield
    assert hopper_jk.ds_jk.launches == 0


@pytest.mark.parametrize("n", [1, 6, 7, 10, 18, 33])
@pytest.mark.parametrize("symmetric", [True, False])
def test_reference_matches_einsum(n, symmetric):
    t, dm = _eri_like(n, seed=n), _dm(n, 1, symmetric)
    trail, mid = hopper_jk.ds_jk_reference(torch.as_tensor(t),
                                           torch.as_tensor(dm))
    assert trail.dtype == torch.float64 and trail.shape == (n, n)
    assert _rel(trail, np.einsum("ijkl,kl->ij", t, dm)) <= 1e-12
    assert _rel(mid, np.einsum("iabl,al->ib", t, dm)) <= 1e-12
    # the wrapper on CPU tensors is the plain version, bit for bit
    w_trail, w_mid = hopper_jk.ds_jk(torch.as_tensor(t), torch.as_tensor(dm))
    assert torch.equal(w_trail, trail) and torch.equal(w_mid, mid)


@pytest.mark.parametrize("n", [6, 10])
@pytest.mark.parametrize("symmetric", [True, False])
def test_reference_matches_jax_reference_on_planes(n, symmetric):
    t, dm = _eri_like(n), _dm(n, 1, symmetric)
    hi, lo = pallas_jk.ds_planes(jnp.asarray(t))
    j_jax, k_jax = pallas_jk.ds_jk_reference(hi, lo, jnp.asarray(dm))
    trail, mid = hopper_jk.ds_jk_reference(torch.as_tensor(t),
                                           torch.as_tensor(dm))
    # JAX names them for a J-layout tensor: (J, K) = (trailing, middle)
    assert _rel(trail, np.asarray(j_jax)) <= 1e-12
    assert _rel(mid, np.asarray(k_jax)) <= 1e-12


@pytest.mark.parametrize("n", [10, 18])
def test_reference_matches_pallas_interpret(n):
    t, dm = _eri_like(n, seed=2), _dm(n, 3)
    hi, lo = pallas_jk.ds_planes(jnp.asarray(t))
    j_jax, k_jax = pallas_jk.ds_jk(hi, lo, jnp.asarray(dm), interpret=True)
    trail, mid = hopper_jk.ds_jk(torch.as_tensor(t), torch.as_tensor(dm))
    scale = max(trail.abs().max().item(), mid.abs().max().item())
    assert np.abs(trail.numpy() - np.asarray(j_jax)).max() / scale < 1e-5
    assert np.abs(mid.numpy() - np.asarray(k_jax)).max() / scale < 1e-5


@pytest.mark.parametrize("symmetric", [True, False])
def test_kplanes_wrapper_identity(symmetric):
    """ds_jk_kplanes on the exchange-layout tensor gives the engine's J and
    K (the production wiring), as the JAX wrapper does on its planes."""
    n = 8
    e_j = _eri_like(n, seed=5)          # J-layout (ij|kl)
    eri_k = np.ascontiguousarray(e_j.transpose(0, 2, 1, 3))
    dm = _dm(n, 6, symmetric)
    j, k = hopper_jk.ds_jk_kplanes(torch.as_tensor(eri_k),
                                   torch.as_tensor(dm))
    j_ref = np.einsum("ikjl,kl->ij", eri_k, dm)   # engine J of eri_k
    k_ref = np.einsum("ijkl,kl->ij", eri_k, dm)   # engine K of eri_k
    np.testing.assert_allclose(j.numpy(), j_ref, atol=1e-11)
    np.testing.assert_allclose(k.numpy(), k_ref, atol=1e-11)
    # and J/K equal the J-layout contractions of the original tensor
    np.testing.assert_allclose(j.numpy(), np.einsum("ijkl,kl->ij", e_j, dm),
                               atol=1e-11)
    np.testing.assert_allclose(k.numpy(), np.einsum("ikjl,kl->ij", e_j, dm),
                               atol=1e-11)
    # the JAX wrapper's oracle on planes of the same tensor
    hi, lo = pallas_jk.ds_planes(jnp.asarray(eri_k))
    k_jax, j_jax = pallas_jk.ds_jk_reference(hi, lo, jnp.asarray(dm))
    np.testing.assert_allclose(j.numpy(), np.asarray(j_jax), atol=1e-11)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_jax), atol=1e-11)


@pytest.mark.parametrize("bad", ["shape", "dm_shape", "dtype", "dm_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    t = torch.zeros((4, 4, 4, 4), dtype=torch.float64)
    dm = torch.zeros((4, 4), dtype=torch.float64)
    if bad == "shape":
        t = torch.zeros((4, 4, 4, 5), dtype=torch.float64)
    elif bad == "dm_shape":
        dm = torch.zeros((4, 5), dtype=torch.float64)
    elif bad == "dtype":
        t = t.float()
    else:
        dm = dm.float()
    with pytest.raises((ValueError, TypeError)):
        hopper_jk.ds_jk(t, dm)


@pytest.mark.parametrize("n", [1, 7, 33, 114, 150, 211])
def test_pick_chunks_covers_the_axis(n):
    a_chunk, n_chunks = hopper_jk.pick_chunks(n)
    assert a_chunk >= 1 and 1 <= n_chunks <= n
    assert a_chunk * n_chunks >= n > a_chunk * (n_chunks - 1)


def test_module_imports_nothing_of_cuda_at_import():
    """The kernel is built and loaded at first use on a CUDA tensor, never
    when the module is imported."""
    import os
    from dqc_tpu_torch.ops import _nvcc
    assert "ds_jk" not in _nvcc._loaded
    assert os.path.isfile(hopper_jk.SOURCE)
    src = open(hopper_jk.SOURCE).read()
    assert "atomicAdd" not in src and 'extern "C" int ds_jk_launch' in src
    assert "compute_90a" in " ".join(_nvcc.NVCC_FLAGS)
