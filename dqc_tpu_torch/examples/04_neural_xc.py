"""Neural-XC training: an XC functional with a learnable enhancement factor
fitted end to end through the SCF fixed point, over a batch of H2
geometries in one batched SCF (parallel/batch.energy_batch: one launch of
each kernel per Fock build for the whole batch; the port's
examples/04_neural_xc.py, whose jax.vmap it replaces).

Run: python -m dqc_tpu_torch.examples.04_neural_xc [--device cpu]
"""
import numpy as np
import torch

import dqc_tpu_torch as dq
from dqc_tpu_torch.parallel.batch import energy_batch
from dqc_tpu_torch.utils.config import resolve_device
from dqc_tpu_torch.utils.datastruct import batch_params
from dqc_tpu_torch.xc.custom import CustomXC

CX = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)


def nn_edens(p, d):
    """LDA-shaped functional with a learnable enhancement factor."""
    rho = d["rho"]
    h = torch.tanh(rho[..., None] ** (1.0 / 3.0) * p["w1"] + p["b1"])
    f = 1.0 + 0.2 * torch.tanh(h @ p["w2"] + p["b2"])[..., 0]
    return -CX * rho ** (4.0 / 3.0) * f


def main(device=None, steps=60, basis="3-21G", grid=1, nbatch=6):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    nn0 = {"w1": 0.1 * rng.standard_normal(8), "b1": np.zeros(8),
           "w2": 0.1 * rng.standard_normal((8, 1)), "b2": np.zeros(1)}
    nn0 = {k: torch.tensor(v, device=dev) for k, v in nn0.items()}
    xc = CustomXC(nn_edens, nn0, family=1, key="nnxc")
    mol = dq.Mol("H -0.5 0 0; H 0.5 0 0", basis=basis, grid=grid,
                 device=device)
    qc = dq.KS(mol, xc=xc)
    # training data: H2 dissociation-curve energies (synthetic targets
    # here; in practice CCSD(T) labels)
    dists = np.linspace(1.0, 2.2, nbatch)
    pos = np.stack([[[-d / 2, 0, 0], [d / 2, 0, 0]] for d in dists])
    targets = torch.tensor(-1.10 - 0.02 * np.sin(dists), device=dev)
    params = {k: v.clone().requires_grad_(True) for k, v in nn0.items()}
    pb = batch_params(qc._all_params(), pos)
    opt = torch.optim.Adam(list(params.values()), lr=3e-3)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        es = energy_batch(qc, dict(pb, xc_params={"nnxc": params}))
        loss = torch.mean((es - targets) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if i % 10 == 0:
            print(f"iter {i}: loss = {losses[-1]:.3e}")
    print(f"final loss = {losses[-1]:.3e}")
    return losses


if __name__ == "__main__":
    from ._args import parse
    a = parse(__doc__, 60)
    main(a.device, a.steps)
