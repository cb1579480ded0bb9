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


SMEM_LIMIT = 232_448      # shared memory one block may opt into on an H100


def _stage_starts(n, plan):
    """(tile, first row, rows) of every ring stage of every block, in the
    order the kernel streams them (tiles in order, rows in order)."""
    spt = -(-n // plan["stage_rows"])
    t = np.repeat(np.arange(n * n), spt)
    b0 = np.tile(np.arange(spt) * plan["stage_rows"], n * n)
    return t, b0, np.minimum(plan["stage_rows"], n - b0)


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("n", range(1, 216))
def test_jk_plan_fits_the_card(n, sms):
    """K1's launch plan: the blocks' tile ranges cover every tile (i,a)
    once and in order, the layout fits a block's shared memory without
    overlaps, and every bulk copy (T's rows, and dm's rows when dm is not
    kept in shared memory) is a 16-byte aligned span that fits its stage,
    whether T and dm start on 16 bytes or 8 bytes past."""
    p = hopper_jk.jk_plan(n, sms)
    tiles, tpb = n * n, p["tiles_per_block"]
    starts = [q * tpb for q in range(p["blocks"])]
    ends = [min(s + tpb, tiles) for s in starts]
    assert 1 <= p["blocks"] <= sms and starts[0] == 0 and ends[-1] == tiles
    assert all(s < e for s, e in zip(starts, ends))
    assert all(e == s for e, s in zip(ends[:-1], starts[1:]))
    # one J slot per i a block meets
    assert p["islots"] == max((e - 1) // n - s // n + 1
                              for s, e in zip(starts, ends))
    # shared memory: ring, dm (if kept there), two mbarriers per stage
    assert p["stage_rows"] % hopper_jk.JK_WARPS == 0
    assert 2 <= p["stages"] <= hopper_jk.JK_MAX_STAGES
    assert p["dm_offset"] == 8 * p["stage_doubles"] * p["stages"]
    dm_bytes = -(-8 * tiles // 16) * 16
    assert p["bar_offset"] == p["dm_offset"] + p["dm_shared"] * dm_bytes
    assert p["smem_bytes"] == p["bar_offset"] + 16 * p["stages"] <= SMEM_LIMIT
    part = p["stage_doubles"] // (2 - p["dm_shared"])
    assert part % 16 == 0 and p["stage_doubles"] % 16 == 0   # 128-byte stages
    # dm stays in shared memory exactly when it leaves room for the fewest
    # stages of T's rows the plan takes
    fits = dm_bytes + hopper_jk.JK_MIN_STAGES * (8 * part + 16) <= SMEM_LIMIT
    assert p["dm_shared"] == fits
    assert p["stages"] >= hopper_jk.JK_MIN_STAGES or not fits
    # every bulk copy: aligned start and size, inside its part of a stage
    t, b0, g = _stage_starts(n, p)
    for base in (0, 8):
        for first in (8 * (t * n * n + b0 * n) + base, 8 * (b0 * n) + base):
            lo = first & ~15
            hi = (first + 8 * g * n + 15) & ~15
            assert np.all((hi - lo) % 16 == 0) and np.all(lo % 16 == 0)
            assert np.all(hi - lo <= 8 * part)
            assert np.all(first - lo <= 8)   # the kernel's lead: 0 or 1


@pytest.mark.parametrize("n,sms", [(0, 132), (257, 132), (7, 0)])
def test_jk_plan_refuses(n, sms):
    with pytest.raises(ValueError, match="jk_plan"):
        hopper_jk.jk_plan(n, sms)


def _replay(t, dm, plan):
    """The kernel's partition in torch: every block's tiles in order, K
    per tile as one slot per warp (rows b = warp mod 16), J per i segment as
    one slot per block; then the fold, slots in index order."""
    n = dm.shape[0]
    w = hopper_jk.JK_WARPS
    tpb, islots = plan["tiles_per_block"], plan["islots"]
    tiles = t.reshape(n * n, n, n)
    k_part = torch.zeros((n * n, w), dtype=t.dtype)
    mid_part = torch.full((plan["blocks"], islots, n), float("nan"),
                          dtype=t.dtype)
    rows_of = [torch.tensor(range(wp, n, w), dtype=torch.long)
               for wp in range(w)]
    for q in range(plan["blocks"]):
        t0, t1 = q * tpb, min((q + 1) * tpb, n * n)
        jacc = torch.zeros(n, dtype=t.dtype)
        for tt in range(t0, t1):
            i, a = divmod(tt, n)
            prod = tiles[tt] * dm                  # T[i,a,b,l] dm[b,l]
            for wp in range(w):
                k_part[tt, wp] = prod[rows_of[wp]].sum()
            jacc += tiles[tt] @ dm[a]              # sum_l T[i,a,b,l] dm[a,l]
            if a == n - 1 or tt == t1 - 1:
                mid_part[q, i - t0 // n] = jacc
                jacc = torch.zeros(n, dtype=t.dtype)
    out_trail = torch.zeros((n, n), dtype=t.dtype)
    out_mid = torch.zeros((n, n), dtype=t.dtype)
    for i in range(n):
        for a in range(n):
            for wp in range(w):
                out_trail[i, a] += k_part[i * n + a, wp]
        for q in range(i * n // tpb, ((i + 1) * n - 1) // tpb + 1):
            out_mid[i] += mid_part[q, i - q * tpb // n]
    assert not torch.isnan(out_mid).any()   # every slot read was written
    return out_trail, out_mid


@pytest.mark.parametrize("sms", [132, 5])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("n", [1, 7, 10, 33])
def test_plan_replay_matches_reference(n, symmetric, sms):
    """Partial J rows per i segment and K slots per warp, folded in index
    order as the kernel's second pass does, give the plain version's J and
    K: the plan's partition loses and repeats nothing."""
    t = torch.as_tensor(_eri_like(n, seed=n + 40))
    dm = torch.as_tensor(_dm(n, 7, symmetric))
    plan = hopper_jk.jk_plan(n, sms)
    trail, mid = _replay(t, dm, plan)
    ref_trail, ref_mid = hopper_jk.ds_jk_reference(t, dm)
    assert _rel(trail, ref_trail.numpy()) <= 1e-12
    assert _rel(mid, ref_mid.numpy()) <= 1e-12


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
