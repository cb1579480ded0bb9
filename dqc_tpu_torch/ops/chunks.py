"""Chunking along one axis (counterpart of dqc_tpu/ops/chunks.py): a Python
loop over blocks bounds the peak memory of `fn`. No padding is needed: the
last block is simply shorter."""
from __future__ import annotations

import torch


def _block(args: dict, s: int, block: int, axes):
    return {k: v.narrow(axes.get(k, 0), s, min(block, v.shape[axes.get(k, 0)]
                                               - s))
            for k, v in args.items()}


def map_blocks(fn, args: dict, n: int, block: int):
    """Apply `fn` to blocks of the leading axis of every tensor in `args`
    (all have leading dim n; constants are closed over in fn). Returns the
    outputs concatenated over the leading axis."""
    if n <= block:
        return fn(args)
    outs = [fn(_block(args, s, block, {})) for s in range(0, n, block)]
    return torch.cat(outs, dim=0)


def map_reduce_blocks(fn, args: dict, n: int, block: int, axes=None):
    """Like map_blocks, but `fn` returns a per-block reduction (a tensor or
    a tuple of tensors without the block axis) and the results are summed
    over the blocks, in block order. `axes` maps a key of `args` to the axis
    of length n that is cut (default 0), e.g. {"ao_grad": 1} for a
    (3, ng, nao) table."""
    axes = axes or {}
    if n <= block:
        return fn(args)
    total = None
    for s in range(0, n, block):
        out = fn(_block(args, s, block, axes))
        if total is None:
            total = out
        elif isinstance(out, tuple):
            total = tuple(a + b for a, b in zip(total, out))
        else:
            total = total + out
    return total
