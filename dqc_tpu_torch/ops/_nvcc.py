"""Building and loading the port's CUDA kernels.

Each source under csrc/ is compiled with nvcc for sm_90a into its own
shared library under dqc_tpu_torch/_build/ (plain C interface, no PyTorch
headers, so a build takes seconds), rebuilt when the source is newer than
the library, and loaded through ctypes. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(looked on PATH, CUDA_HOME, /usr/local/cuda)")


def build(name: str, force: bool = False) -> dict:
    """Compile csrc/<name>.cu into lib<name>.so if the library is missing or
    older than the source (always with force=True).
    Returns {'seconds', 'built', 'log'}; the log holds ptxas' report."""
    t0 = time.perf_counter()
    src, lib = source_path(name), library_path(name)
    fresh = (os.path.isfile(lib)
             and os.path.getmtime(lib) >= os.path.getmtime(src))
    if fresh and not force:
        return {"seconds": 0.0, "built": False, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = lib + f".{os.getpid()}.tmp"
    res = subprocess.run([find_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building {src}:"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    _loaded.pop(name, None)
    return {"seconds": time.perf_counter() - t0, "built": True,
            "log": (res.stdout + res.stderr).strip()}


def load(name: str, symbols: dict):
    """The ctypes library of csrc/<name>.cu, built if needed. `symbols`
    maps each C function to its argument types; all return an int
    (the cudaError_t of the launch)."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in symbols.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib


def ptr(n: int):
    """argtypes of n device pointers."""
    return [ctypes.c_void_p] * n


def ints(n: int):
    return [ctypes.c_int] * n

