"""Molecule description parser (counterpart of dqc_tpu/api/parser.py).

"H 1 0 0; H -1 0 0" or (atomzs, atompos) -> (atomzs, atompos) tensors in
Bohr on the requested device. A position tensor the caller owns is kept as
given (moved to the device, never detached) so gradients can flow later.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.config import DTYPE, resolve_device
from ..utils.periodictable import get_atomz
from ..utils.units import length_to_au

MolDesc = Union[str, Tuple[Sequence, object]]


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=DTYPE)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def parse_moldesc(moldesc: MolDesc, unit: str = None, device=None):
    """Parse the molecule description into (atomzs, atompos).

    atomzs: (natoms,) float64 tensor (may be fractional)
    atompos: (natoms, 3) float64 tensor in Bohr
    """
    device = resolve_device(device)
    if isinstance(moldesc, str):
        atomzs = []
        pos = []
        for chunk in moldesc.replace("\n", ";").split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            toks = chunk.split()
            if len(toks) != 4:
                raise ValueError(f"Bad atom spec: {chunk!r}")
            atomzs.append(get_atomz(toks[0]))
            pos.append([float(t) for t in toks[1:]])
        atomzs_arr = _as_tensor(atomzs, device)
        pos_arr = _as_tensor(pos, device)
    else:
        zs, p = moldesc
        if isinstance(zs, (list, tuple)):
            zs = [get_atomz(z) if isinstance(z, str) else z for z in zs]
        atomzs_arr = _as_tensor(zs, device)
        pos_arr = _as_tensor(p, device)
        if pos_arr.ndim != 2 or pos_arr.shape[-1] != 3:
            raise ValueError("atompos must have shape (natoms, 3)")
    pos_arr = length_to_au(pos_arr, unit) if unit else pos_arr
    return atomzs_arr, pos_arr
