"""Pair-axis chunking (counterpart of dqc_tpu/ops/chunks.py): a Python loop
over blocks of the leading axis bounds the peak memory of `fn`. No padding
is needed: the last block is simply shorter."""
from __future__ import annotations

import torch


def map_blocks(fn, args: dict, n: int, block: int):
    """Apply `fn` to blocks of the leading axis of every tensor in `args`
    (all have leading dim n; constants are closed over in fn). Returns the
    outputs concatenated over the leading axis."""
    if n <= block:
        return fn(args)
    outs = [fn({k: v[s:s + block] for k, v in args.items()})
            for s in range(0, n, block)]
    return torch.cat(outs, dim=0)
