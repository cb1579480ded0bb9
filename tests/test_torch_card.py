"""PyTorch/CUDA port: tests that need an NVIDIA GPU.

Run them on a machine with a card:

    python -m pytest tests/test_torch_card.py -q

Without a card every test here skips (decided inside the test, not at
import). The file imports the port and PyTorch only, so it also runs where
JAX is not installed. The CUDA kernel has no interpret mode: its plain
PyTorch version `ds_jk_reference` is what it is held against, to the 1e-10
relative gate the JAX package uses for its own kernel on its chip.
"""
import numpy as np
import pytest
import torch

import dqc_tpu_torch as dqt
from dqc_tpu_torch.ops import hopper_jk
from dqc_tpu_torch.scf.engine import HFEngine

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda_card]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only there")


def _eri_like(n, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n, n, n)) * np.exp(
        rng.uniform(-8, 1, (n, n, n, n)))
    t = t + t.transpose(1, 0, 2, 3)
    t = t + t.transpose(0, 1, 3, 2)
    t = t + t.transpose(2, 3, 0, 1)
    return torch.as_tensor(np.ascontiguousarray(t), device="cuda")


@pytest.mark.parametrize("n", [1, 7, 33, 66])
@pytest.mark.parametrize("symmetric", [True, False])
def test_kernel_matches_plain_version(n, symmetric):
    _need_card()
    t = _eri_like(n, seed=n)
    rng = np.random.default_rng(3)
    dm = rng.standard_normal((n, n))
    dm = torch.as_tensor(dm + dm.T if symmetric else dm, device="cuda")
    before = hopper_jk.ds_jk.launches
    out = hopper_jk.ds_jk(t, dm)
    again = hopper_jk.ds_jk(t, dm)
    ref = hopper_jk.ds_jk_reference(t, dm)
    torch.cuda.synchronize()
    assert hopper_jk.ds_jk.launches == before + 2
    for a, b, r in zip(out, again, ref):
        assert (a - r).abs().max().item() <= 1e-10 * r.abs().max().item()
        assert torch.equal(a, b)          # no atomics: bit-identical


def test_kernel_refuses_non_contiguous_and_wrong_dtype():
    _need_card()
    t = _eri_like(6, seed=1)
    dm = torch.eye(6, dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError):
        hopper_jk.ds_jk(t.permute(0, 2, 1, 3), dm)
    with pytest.raises(TypeError):
        hopper_jk.ds_jk(t.float(), dm.float())
    with pytest.raises(ValueError):
        hopper_jk.ds_jk(t, dm.cpu())


def test_hf_runs_on_the_card_by_default():
    _need_card()
    mol = dqt.Mol("H -0.5 0 0; H 0.5 0 0", basis="3-21G")
    assert mol.device.type == "cuda"
    hopper_jk.ds_jk.launches = 0
    qc = dqt.HF(mol).run()
    assert hopper_jk.ds_jk.launches >= qc.stats["iterations"] + 1
    assert abs(float(qc.energy()) - (-1.07195346)) < 1e-6
    cpu = dqt.HF(dqt.Mol("H -0.5 0 0; H 0.5 0 0", basis="3-21G",
                         device="cpu")).run()
    assert abs(float(qc.energy()) - float(cpu.energy())) < 1e-10


def test_engine_jk_parts_goes_through_the_kernel():
    _need_card()
    n = 10
    t = _eri_like(n, seed=4)
    rng = np.random.default_rng(5)
    dm = rng.standard_normal((2, n, n))
    dm = torch.as_tensor(dm + dm.transpose(0, 2, 1), device="cuda")
    hopper_jk.ds_jk.launches = 0
    j, k = HFEngine(polarized=True).jk_parts(dm, {"eri_k": t})
    assert hopper_jk.ds_jk.launches == 2
    jr = torch.einsum("ikjl,kl->ij", t, dm.sum(0))
    kr = torch.einsum("ijkl,skl->sij", t, dm)
    assert (j - jr).abs().max().item() <= 1e-10 * jr.abs().max().item()
    assert (k - kr).abs().max().item() <= 1e-10 * kr.abs().max().item()
