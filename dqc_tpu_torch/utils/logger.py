"""Progress logging gated by config.VERBOSE (counterpart of
dqc_tpu/utils/logger.py; the profiler-trace helper is not ported)."""
from __future__ import annotations

import sys

from .config import config


def log(*args, level: int = 1):
    if config.VERBOSE >= level:
        print("[dqc-tpu-torch]", *args, file=sys.stderr, flush=True)
