"""The command line every example shares."""
from __future__ import annotations

import argparse


def parse(doc: str, steps: int):
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--steps", type=int, default=steps,
                   help="optimiser steps (where the example takes any)")
    return p.parse_args()
