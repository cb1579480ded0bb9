"""Global configuration knobs and the device rule of the port.

Counterpart of dqc_tpu/utils/config.py. The port runs on the CUDA card unless
the caller asks for the CPU: `resolve_device(None)` means "cuda" and raises
when no card is present. Nothing carries on on the CPU by itself.
"""
from __future__ import annotations

import os as _os
from dataclasses import dataclass

import torch


@dataclass
class _Config:
    # target size in bytes of the Hermite-R intermediates of one bra block
    # in coulomb_contract, which picks its block from it. The estimate counts
    # the recursion's tensors, not the copies einsum and bmm make, so the
    # peak of eri_dense is several times larger: on an H100, benzene/def2-SVP,
    # 512 MiB here gave a 7.6 GiB peak and the same build time as 1 GiB
    ERI_R_BYTES: int = 512 * 1024 ** 2
    # the dense route (eri_k and K1) is taken while its nao^4 f64 ERI
    # tensors fit in this many bytes (80 GB card); above it the blocked or
    # the streamed route. Measured peak of a B3LYP SCF on an H100: 2.81x
    # the tensor at nao = 208 (42.0 GB for 15.0 GB: the symmetrisation and
    # the exchange layout each hold two tensors), 6.4x at nao = 114 (8.7
    # GB), where the build's fixed-size temporaries weigh more; range
    # separation adds one tensor per omega (KS counts them against this
    # limit together)
    DENSE_ERI_BYTES_LIMIT: int = 16 * 1024 ** 3
    # past the dense limit, the blocked route caches the canonical quartet
    # blocks (scf/jk.py) while they fit in this many bytes; above it the
    # streamed route rebuilds them on every Fock build. Measured peak of a
    # blocked B3LYP SCF on an H100: 8.7x and 12.8x the blocks at nao = 208
    # in two runs (18.6 and 27.4 GB for 2.14 GB: the quartet build's
    # temporaries and the grid tables come on top), so 4 GiB of blocks
    # stays under the 80 GB card even at the larger ratio
    BLOCKED_JK_BYTES_LIMIT: int = 4 * 1024 ** 3
    # k-point exact exchange keeps the mixed pair-transform stack of every
    # (k, k') pair, nk^2 ng nao^2 complex entries (scf/kpbc.py); a mesh
    # whose stack passes this many bytes raises. H8 (nao 16, 98,900 G) on
    # a 2x2x2 mesh needs 25.9 GB, on a 3x3x3 mesh 295 GB
    KPBC_EXX_BYTES_LIMIT: int = 32 * 1024 ** 3
    # verbosity: 0 silent, 1 progress lines, 2 debug
    VERBOSE: int = 0    # overridden by env DQC_TPU_VERBOSE at import


config = _Config()
config.VERBOSE = int(_os.environ.get("DQC_TPU_VERBOSE", config.VERBOSE))

DTYPE = torch.float64


# the periodic path (pair Fourier transforms, exchange, Becke weights of the
# wrapped grid, lattice-summed AO tables) cuts its largest axis into blocks
# whose temporaries take about this many bytes, by device type
PBC_BLOCK_BYTES = {"cuda": 1024 ** 3, "cpu": 128 * 1024 ** 2}


def block_bytes(device) -> int:
    """The byte budget of one block of the periodic path on `device`."""
    return PBC_BLOCK_BYTES[torch.device(device).type]


def resolve_device(device=None) -> torch.device:
    """The device a calculation runs on. None means the CUDA card; without
    one the caller has to ask for the CPU by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dqc_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
