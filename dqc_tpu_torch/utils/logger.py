"""Progress logging gated by config.VERBOSE, a timer, and a profiler trace
(counterpart of dqc_tpu/utils/logger.py, whose trace is jax.profiler's).
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

from .config import config


def log(*args, level: int = 1):
    if config.VERBOSE >= level:
        print("[dqc-tpu-torch]", *args, file=sys.stderr, flush=True)


@contextlib.contextmanager
def timed(label: str, level: int = 1):
    """Logs the seconds the block took (host clock; on the card without a
    synchronise, the time to enqueue)."""
    t0 = time.perf_counter()
    yield
    log(f"{label}: {time.perf_counter() - t0:.3f}s", level=level)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Records a torch.profiler trace of the block, the host's operators
    and, with a card present, its kernels (CUDA activity), and writes it
    to logdir/trace.json as a Chrome trace (chrome://tracing, Perfetto).
    Yields the profiler, whose key_averages() sums the time by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
