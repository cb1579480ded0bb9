"""PyTorch/CUDA port: the examples (dqc_tpu_torch/examples/), on the CPU.

Every example imports neither jax nor the JAX package (an AST check of
every file), takes a device, and 04 (neural-XC training through the
batched SCF) runs two Adam steps at H2/STO-3G to a finite, falling loss.
"""
import ast
import glob
import importlib
import inspect
import math
import os

import pytest
import torch

import dqc_tpu_torch

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

EXAMPLES = os.path.join(os.path.dirname(dqc_tpu_torch.__file__), "examples")
NAMES = ["01_equil_pos", "02_optimizing_basis", "03_alchemy_gradient",
         "04_neural_xc", "05_pbc_solid", "06_ir_raman"]


def _imports(path):
    mods = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    return mods


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(EXAMPLES,
                                                               "*.py"))))
def test_examples_import_neither_jax_nor_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "dqc_tpu", "optax"}


@pytest.mark.parametrize("name", NAMES)
def test_every_example_takes_a_device(name):
    mod = importlib.import_module(f"dqc_tpu_torch.examples.{name}")
    assert "device" in inspect.signature(mod.main).parameters


def test_neural_xc_example_trains_two_steps_on_the_cpu():
    mod = importlib.import_module("dqc_tpu_torch.examples.04_neural_xc")
    losses = mod.main("cpu", steps=2, basis="sto-3g", grid=0, nbatch=3)
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert losses[1] < losses[0]


def test_profile_trace_writes_a_chrome_trace_and_timed_logs(tmp_path,
                                                            capsys):
    """utils/logger: profile_trace records the block with torch.profiler
    and writes logdir/trace.json; timed logs the block's seconds."""
    import json
    from dqc_tpu_torch.utils import logger
    from dqc_tpu_torch.utils.config import config
    with logger.profile_trace(str(tmp_path)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    names = {e.key for e in prof.key_averages()}
    assert any("matmul" in n or "mm" in n for n in names)
    trace = json.load(open(tmp_path / "trace.json"))
    assert trace["traceEvents"]
    old, config.VERBOSE = config.VERBOSE, 1
    try:
        with logger.timed("block"):
            pass
    finally:
        config.VERBOSE = old
    assert "block:" in capsys.readouterr().err
