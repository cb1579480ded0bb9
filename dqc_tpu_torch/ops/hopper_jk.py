"""Fused J+K contraction: wrapper of the hand-written Hopper kernel.

Replaces the TPU kernel dqc_tpu/ops/pallas_jk.py::ds_jk (and its wrapper
ds_jk_kplanes). One pass over a dense 4-index float64 tensor T forms

  out_trail[i,j] = sum_kl T[i,j,k,l] dm[k,l]   (trailing axes)
  out_mid[i,b]   = sum_al T[i,a,b,l] dm[a,l]   (axes 1 and 3)

For T = eri_k (eri_k[i,j,k,l] = (ik|jl)): (out_trail, out_mid) = (K, J).

The kernel is csrc/ds_jk.cu (CUDA C++ for sm_90a; its header says what it
is bounded by — bytes: T is read once — and how it is laid out). There are
no hi/lo f32 planes here: the card has f64 arithmetic and the f64 tensor is
the input.

Dispatch: a tensor on the CPU takes the plain PyTorch version
`ds_jk_reference`; a CUDA tensor launches the kernel or raises. Nothing
switches the kernel off. The kernel is forward only, like the one it
replaces: handed a CUDA tensor that requires grad under autograd, the
wrapper raises; the plain version on the CPU passes autograd through.

The shared library is built at first use with nvcc into
dqc_tpu_torch/_build/ and loaded through ctypes (ops/_nvcc.py); nothing
CUDA-only is touched at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc

SOURCE = _nvcc.source_path("ds_jk")
_SYMBOLS = {"ds_jk_launch": _nvcc.ptr(5) + _nvcc.ints(3) + [ctypes.c_void_p]}


def build(force: bool = False) -> dict:
    """Compile csrc/ds_jk.cu if its library is missing or stale (always
    with force=True). Returns {'seconds', 'built', 'log'}."""
    return _nvcc.build("ds_jk", force=force)


def _load():
    return _nvcc.load("ds_jk", _SYMBOLS)


def pick_chunks(n: int):
    """(a_chunk, n_chunks): how the axis `a` is cut into blocks. About 2048
    blocks (n * n_chunks) keep all multiprocessors of the card busy with
    several blocks each; a chunk never has less than one row."""
    want = max(1, min(n, -(-2048 // n)))
    a_chunk = -(-n // want)
    return a_chunk, -(-n // a_chunk)


def _check(T, dm):
    if T.ndim != 4 or len(set(T.shape)) != 1:
        raise ValueError(f"T must be (n,n,n,n), got {tuple(T.shape)}")
    n = T.shape[0]
    if tuple(dm.shape) != (n, n):
        raise ValueError(f"dm must be ({n},{n}), got {tuple(dm.shape)}")
    if T.dtype != torch.float64 or dm.dtype != torch.float64:
        raise TypeError("ds_jk takes float64 tensors, got "
                        f"{T.dtype} and {dm.dtype}")
    if T.device != dm.device:
        raise ValueError(f"T on {T.device} but dm on {dm.device}")


def ds_jk_reference(T, dm):
    """Plain PyTorch version of the kernel: the same two contractions as
    two float64 einsums. Used on CPU tensors and as the oracle the kernel is
    held against on the card."""
    out_trail = torch.einsum("ijkl,kl->ij", T, dm)
    out_mid = torch.einsum("iabl,al->ib", T, dm)
    return out_trail, out_mid


def ds_jk(T, dm):
    """(out_trail, out_mid) of T (n,n,n,n) and dm (n,n), float64.

    CPU tensors: the plain version (differentiable). CUDA tensors: the
    kernel; T and dm must be contiguous. Raises on anything the kernel does
    not take, on a failed build or launch, and under autograd."""
    _check(T, dm)
    if T.device.type == "cpu":
        return ds_jk_reference(T, dm)
    if T.device.type != "cuda":
        raise RuntimeError(f"ds_jk has no kernel for device {T.device}")
    _nvcc.no_autograd("ds_jk", T, dm)
    if not T.is_contiguous() or not dm.is_contiguous():
        raise ValueError("ds_jk needs contiguous T and dm on the card")
    lib = _load()
    n = T.shape[0]
    a_chunk, n_chunks = pick_chunks(n)
    with torch.cuda.device(T.device):
        out_trail = torch.empty((n, n), dtype=T.dtype, device=T.device)
        out_mid = torch.empty((n, n), dtype=T.dtype, device=T.device)
        mid_part = torch.empty((n, n_chunks, n), dtype=T.dtype,
                               device=T.device)
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = lib.ds_jk_launch(T.data_ptr(), dm.data_ptr(),
                               out_trail.data_ptr(), out_mid.data_ptr(),
                               mid_part.data_ptr(), n, a_chunk, n_chunks,
                               stream)
    if err != 0:
        raise RuntimeError(f"ds_jk kernel launch failed: cudaError {err} "
                           f"(n={n}, a_chunk={a_chunk}, n_chunks={n_chunks})")
    ds_jk.launches += 1
    return out_trail, out_mid


ds_jk.launches = 0   # launches of the CUDA kernel (never the plain version)


def ds_jk_kplanes(T, dm):
    """(J, K) from the EXCHANGE-layout tensor eri_k, the layout theta
    carries. With eri_k[i,j,k,l] = (ik|jl):
      trailing contraction = K  (einsum("ijkl,kl->ij", eri_k, dm))
      middle contraction   = J  (einsum("ikjl,kl->ij", eri_k, dm))
    """
    k, j = ds_jk(T, dm)
    return j, k
