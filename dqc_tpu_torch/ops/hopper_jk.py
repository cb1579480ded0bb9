"""Fused J+K contraction: wrapper of the hand-written Hopper kernel.

Replaces the TPU kernel dqc_tpu/ops/pallas_jk.py::ds_jk (and its wrapper
ds_jk_kplanes). One pass over a dense 4-index float64 tensor T forms

  out_trail[i,j] = sum_kl T[i,j,k,l] dm[k,l]   (trailing axes)
  out_mid[i,b]   = sum_al T[i,a,b,l] dm[a,l]   (axes 1 and 3)

For T = eri_k (eri_k[i,j,k,l] = (ik|jl)): (out_trail, out_mid) = (K, J).

Batch axis: T (B,n,n,n,n) with dm (B,n,n) gives (B,n,n) outputs, member by
member, in ONE launch for the whole batch (what jax.vmap of the TPU kernel
computes; parallel/batch.py's batched SCF makes one such launch per Fock
build). The kernel offsets its own pointers by the member strides; an
unbatched call is the batch of one and gives the bits it always gave.

The kernel is csrc/ds_jk.cu (CUDA C++ for sm_90a; its header says what it
is bounded by — bytes: T is read once — and how it streams T). There are
no hi/lo f32 planes here: the card has f64 arithmetic and the f64 tensor is
the input. `jk_plan` decides the launch and the shared-memory layout on the
host; the kernel checks the plan and refuses one that does not fit it.

Dispatch: a tensor on the CPU takes the plain PyTorch version
`ds_jk_reference`; a CUDA tensor launches the kernel or raises. Nothing
switches the kernel off.

Derivatives (`_DsJk`, a torch.autograd.Function; the TPU kernel had none,
its gradients took the einsum path). For a T with the pair symmetries of
eri_k (eri_k[i,j,k,l] = (ik|jl)),
  T[i,j,k,l] = T[k,l,i,j]   ((ik|jl) = (ki|lj)), and
  T[i,j,k,l] = T[j,i,l,k]   ((ik|jl) = (jl|ik)),
the cotangent in dm is the kernel itself applied to the cotangents:
  dmbar = out_trail(T, out_trail_bar) + out_mid(T, out_mid_bar),
two more launches through the same Function, so every higher order works
too (the Raman spectrum's third derivative launches K1 in each backward).
The first symmetry gives the trailing term, the second the middle one.
`_assert_pair_symmetric` checks both once per T with two probe contractions
through the kernel and raises for a T without them. The cotangent of T,
  Tbar[i,j,k,l] = out_trail_bar[i,j] dm[k,l] + out_mid_bar[i,k] dm[j,l],
is a dense n^4 tensor of outer products in plain torch (1.35 GB at
n = 114): a backward contraction that no TPU kernel computed.

The shared library is built at first use with nvcc into
dqc_tpu_torch/_build/ and loaded through ctypes (ops/_nvcc.py); nothing
CUDA-only is touched at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _nvcc

SOURCE = _nvcc.source_path("ds_jk")

# the kernel's consumer warps (kConsumerWarps: row b of every tile belongs
# to warp b mod JK_WARPS), its deepest ring (kMaxStages) and its largest n
# (kMaxN: lane takes columns lane + 32 j, j < 8); the fewest stages the plan
# takes, and the bytes of T one stage aims at (below about 28 KB the
# per-stage work shows; see PERF.md); the shared memory a block may opt
# into on an H100 and the multiprocessors of an H100
JK_WARPS = 16
JK_MAX_STAGES = 6
JK_MIN_STAGES = 3
JK_MAX_N = 256
JK_STAGE_BYTES = 32 * 1024
SMEM_LIMIT = 232_448
H100_SMS = 132

# the launch arguments that jk_plan decides, in the kernel's order
PLAN_KEYS = ("blocks", "tiles_per_block", "stage_rows", "stages",
             "stage_doubles", "dm_shared", "islots", "dm_offset",
             "bar_offset", "smem_bytes")
_SYMBOLS = {"ds_jk_launch": _nvcc.ptr(6) + _nvcc.ints(2)
            + [ctypes.c_longlong] * 2 + _nvcc.ints(len(PLAN_KEYS))
            + [ctypes.c_void_p]}


def build(force: bool = False) -> dict:
    """Compile csrc/ds_jk.cu if its library is missing or stale (always
    with force=True). Returns {'seconds', 'built', 'log'}."""
    return _nvcc.build("ds_jk", force=force)


def _load():
    return _nvcc.load("ds_jk", _SYMBOLS)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def jk_plan(n: int, sms: int = H100_SMS, batch: int = 1) -> dict:
    """Launch plan and shared-memory layout of the ds_jk kernel for `batch`
    tensors T (n,n,n,n) on a card with `sms` multiprocessors.

    One block per multiprocessor, each owning `tiles_per_block` consecutive
    tiles T[m,i,a,:,:] of the batch's B n^2 (the last block fewer; a range
    may cross from one member to the next). A ring stage carries
    `stage_rows` rows of one tile (a multiple of JK_WARPS, about
    JK_STAGE_BYTES) plus one double on each side for the 16-byte aligned
    span of the bulk copy, rounded to 128 bytes. dm stays in shared memory
    (`dm_shared`) when it fits beside JK_MIN_STAGES stages; otherwise each
    stage also carries the same rows of dm, in its second half
    (`stage_doubles` is then twice the rows' room). As many stages as fit,
    at most JK_MAX_STAGES. `islots`: the J slots a block needs, one per i
    its tiles meet. Shared memory, in bytes from 0: the ring, dm at
    `dm_offset` (if shared), two mbarriers per stage at `bar_offset`;
    `smem_bytes` in all. The kernel checks this plan and lays out nothing
    itself."""
    if not 1 <= n <= JK_MAX_N or sms < 1 or batch < 1:
        raise ValueError(f"jk_plan: n = {n} must be in [1, {JK_MAX_N}], "
                         f"sms = {sms} and batch = {batch} >= 1")
    tiles = batch * n * n
    tiles_per_block = -(-tiles // sms)
    blocks = -(-tiles // tiles_per_block)
    stage_rows = min(_round_up(n, JK_WARPS), JK_WARPS * max(
        1, round(JK_STAGE_BYTES / (JK_WARPS * 8 * n))))
    rows_doubles = _round_up(min(stage_rows, n) * n + 2, 16)
    for dm_shared in (1, 0):
        stage_doubles = rows_doubles * (2 - dm_shared)
        dm_bytes = dm_shared * _round_up(8 * tiles, 16)
        stages = min(JK_MAX_STAGES,
                     (SMEM_LIMIT - dm_bytes) // (8 * stage_doubles + 16))
        if stages >= JK_MIN_STAGES:
            break
    islots = max((min(t0 + tiles_per_block, tiles) - 1) // n - t0 // n + 1
                 for t0 in range(0, tiles, tiles_per_block))
    dm_offset = 8 * stage_doubles * stages
    bar_offset = dm_offset + dm_bytes
    return {"blocks": blocks, "tiles_per_block": tiles_per_block,
            "stage_rows": stage_rows, "stages": stages,
            "stage_doubles": stage_doubles, "dm_shared": dm_shared,
            "islots": islots, "dm_offset": dm_offset,
            "bar_offset": bar_offset, "smem_bytes": bar_offset + 16 * stages}


@functools.lru_cache(maxsize=64)
def _launch_plan(n: int, batch: int, device_index: int) -> dict:
    """jk_plan for the card `device_index`, kept per (n, batch): the SCF
    calls the kernel at one shape every iteration."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return jk_plan(n, sms, batch)


def _check(T, dm):
    if T.ndim not in (4, 5) or len(set(T.shape[-4:])) != 1:
        raise ValueError(f"T must be (n,n,n,n) or (B,n,n,n,n), got "
                         f"{tuple(T.shape)}")
    n = T.shape[-1]
    want = tuple(T.shape[:-4]) + (n, n)
    if tuple(dm.shape) != want:
        raise ValueError(f"dm must be {want}, got {tuple(dm.shape)}")
    if T.dtype != torch.float64 or dm.dtype != torch.float64:
        raise TypeError("ds_jk takes float64 tensors, got "
                        f"{T.dtype} and {dm.dtype}")
    if T.device != dm.device:
        raise ValueError(f"T on {T.device} but dm on {dm.device}")


def ds_jk_reference(T, dm):
    """Plain PyTorch version of the kernel: the same two contractions as
    two float64 einsums, member by member for a batch (so each member has
    the bits of its unbatched call). Used on CPU tensors and as the oracle
    the kernel is held against on the card."""
    if T.ndim == 5:
        outs = [ds_jk_reference(t, d) for t, d in zip(T, dm)]
        return tuple(torch.stack(o) for o in zip(*outs))
    out_trail = torch.einsum("ijkl,kl->ij", T, dm)
    out_mid = torch.einsum("iabl,al->ib", T, dm)
    return out_trail, out_mid


def _forward(T, dm):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if T.device.type == "cpu":
        return ds_jk_reference(T, dm)
    if T.device.type != "cuda":
        raise RuntimeError(f"ds_jk has no kernel for device {T.device}")
    return _launch(T, dm)


# relative gate of the probe contractions that check T's pair symmetries
PAIR_SYM_REL = 1e-10


def _assert_pair_symmetric(T):
    """Raise unless T has the two pair symmetries the dm-cotangent rule of
    ds_jk relies on. For seeded probes P, Q (not symmetric):
    <Q, trail(P)> = <P, trail(Q)> tests T[i,j,k,l] = T[k,l,i,j] and
    <Q, mid(P)> = <P, mid(Q)> tests T[i,j,k,l] = T[j,i,l,k]. Two launches,
    once per T (marked on the tensor with its version); a batch is checked
    member by member, the same probes for every member."""
    if getattr(T, "_pair_sym_version", None) == T._version:
        return
    n = T.shape[-1]
    g = torch.Generator().manual_seed(11)
    P, Q = (torch.randn((n, n), generator=g, dtype=T.dtype).to(T.device)
            .expand(T.shape[:-4] + (n, n)).contiguous() for _ in range(2))
    with torch.no_grad():
        tp, mp = _forward(T, P)
        tq, mq = _forward(T, Q)
        for name, op, oq in (("T[i,j,k,l] = T[k,l,i,j]", tp, tq),
                             ("T[i,j,k,l] = T[j,i,l,k]", mp, mq)):
            # relative to the Cauchy-Schwarz bound of both sides, per member
            scale = (_norm2(Q) * _norm2(op) + _norm2(P) * _norm2(oq))
            diff = ((Q * op).sum((-1, -2)) - (P * oq).sum((-1, -2))).abs()
            if bool((diff > PAIR_SYM_REL * scale.clamp_min(1e-300)).any()):
                raise ValueError(
                    f"ds_jk backward: T lacks the pair symmetry {name} "
                    "that makes the dm cotangent a ds_jk of the "
                    "cotangents")
    T._pair_sym_version = T._version


def _norm2(x):
    """Frobenius norm over the last two axes."""
    return torch.linalg.matrix_norm(x)


class _DsJk(torch.autograd.Function):

    @staticmethod
    def forward(ctx, T, dm):
        ctx.save_for_backward(T, dm)
        return _forward(T, dm)

    @staticmethod
    def backward(ctx, trail_bar, mid_bar):
        T, dm = ctx.saved_tensors
        tbar = dmbar = None
        if ctx.needs_input_grad[1]:
            _assert_pair_symmetric(T)
            dmbar = (_DsJk.apply(T, trail_bar.contiguous())[0]
                     + _DsJk.apply(T, mid_bar.contiguous())[1])
        if ctx.needs_input_grad[0]:
            tbar = (trail_bar[..., :, :, None, None]
                    * dm[..., None, None, :, :]
                    + mid_bar[..., :, None, :, None]
                    * dm[..., None, :, None, :])
        return tbar, dmbar


def ds_jk(T, dm):
    """(out_trail, out_mid) of T (n,n,n,n) and dm (n,n), float64, or of a
    batch T (B,n,n,n,n) and dm (B,n,n) member by member ((B,n,n) each; one
    launch for the batch).

    CPU tensors: the plain version. CUDA tensors: the kernel; T and dm must
    be contiguous. Differentiable on both (see the module docstring: the dm
    cotangent needs T's pair symmetries). Raises on anything the kernel
    does not take and on a failed build or launch."""
    _check(T, dm)
    return _DsJk.apply(T, dm)


def _launch(T, dm):
    """One launch of the kernel on CUDA tensors T and dm."""
    if not T.is_contiguous() or not dm.is_contiguous():
        raise ValueError("ds_jk needs contiguous T and dm on the card")
    lib = _load()
    n = T.shape[-1]
    lead = tuple(T.shape[:-4])
    batch = lead[0] if lead else 1
    plan = _launch_plan(n, batch, T.device.index)
    with torch.cuda.device(T.device):
        out_trail = torch.empty(lead + (n, n), dtype=T.dtype, device=T.device)
        out_mid = torch.empty(lead + (n, n), dtype=T.dtype, device=T.device)
        k_part = torch.empty((batch * n * n, JK_WARPS), dtype=T.dtype,
                             device=T.device)
        mid_part = torch.empty((plan["blocks"], plan["islots"], n),
                               dtype=T.dtype, device=T.device)
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = lib.ds_jk_launch(T.data_ptr(), dm.data_ptr(),
                               out_trail.data_ptr(), out_mid.data_ptr(),
                               k_part.data_ptr(), mid_part.data_ptr(), n,
                               batch, n ** 4, n * n,
                               *(plan[k] for k in PLAN_KEYS), stream)
    if err != 0:
        raise RuntimeError(f"ds_jk kernel launch failed: cudaError {err} "
                           f"(n={n}, batch={batch}, plan={plan})")
    ds_jk.launches += 1
    tag = getattr(T, "jk_tag", "eri_k")
    ds_jk.launches_by_tag[tag] = ds_jk.launches_by_tag.get(tag, 0) + 1
    return out_trail, out_mid


ds_jk.launches = 0   # launches of the CUDA kernel (never the plain version)
# the same launches by the `jk_tag` attribute of T ("eri_lr" on the
# erf-attenuated tensors of scf/qccalc; untagged tensors count as "eri_k")
ds_jk.launches_by_tag = {}


def ds_jk_kplanes(T, dm):
    """(J, K) from the EXCHANGE-layout tensor eri_k, the layout theta
    carries. With eri_k[i,j,k,l] = (ik|jl):
      trailing contraction = K  (einsum("ijkl,kl->ij", eri_k, dm))
      middle contraction   = J  (einsum("ikjl,kl->ij", eri_k, dm))
    """
    k, j = ds_jk(T, dm)
    return j, k
