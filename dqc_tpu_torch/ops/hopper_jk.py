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
switches the kernel off. Forward only, like the kernel it replaces.

The shared library is built at first use with nvcc into
dqc_tpu_torch/_build/ and loaded through ctypes; nothing CUDA-only is
touched at import.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_PKG, "csrc", "ds_jk.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libds_jk.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the J+K kernel cannot be built "
                       "(looked on PATH, CUDA_HOME, /usr/local/cuda)")


def build(force: bool = False) -> dict:
    """Compile csrc/ds_jk.cu into the shared library if it is missing or
    older than the source. Returns {'seconds', 'built', 'log'}."""
    t0 = time.perf_counter()
    fresh = (os.path.isfile(LIBRARY)
             and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE))
    if fresh and not force:
        return {"seconds": 0.0, "built": False, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIBRARY + f".{os.getpid()}.tmp"
    cmd = [_find_nvcc()] + NVCC_FLAGS + ["-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {SOURCE}:\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, LIBRARY)
    return {"seconds": time.perf_counter() - t0, "built": True,
            "log": (res.stdout + res.stderr).strip()}


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        lib.ds_jk_launch.restype = ctypes.c_int
        lib.ds_jk_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        _lib = lib
    return _lib


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

    CPU tensors: the plain version. CUDA tensors: the kernel; T and dm must
    be contiguous. Raises on anything the kernel does not take and on a
    failed build or launch."""
    _check(T, dm)
    if T.device.type == "cpu":
        return ds_jk_reference(T, dm)
    if T.device.type != "cuda":
        raise RuntimeError(f"ds_jk has no kernel for device {T.device}")
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
