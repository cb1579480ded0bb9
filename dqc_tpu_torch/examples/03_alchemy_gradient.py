"""Alchemical derivatives of N2 (HF/3-21G): dE/dZ and d2E/dZ2 at a fixed
electron count, through the SCF (the port's examples/03_alchemy_gradient.py).

Run: python -m dqc_tpu_torch.examples.03_alchemy_gradient [--device cpu]
"""
import torch

import dqc_tpu_torch as dq


def main(device=None, steps=0):
    qc = dq.HF(dq.Mol("N -1.0 0 0; N 1.0 0 0", basis="3-21G", device=device))
    p0 = qc._all_params()

    def ene(zs):
        return qc.energy_fn(dict(p0, atomzs=zs))

    z0 = p0["atomzs"].detach()
    e = ene(z0)
    g = torch.autograd.functional.jacobian(ene, z0)
    h = torch.autograd.functional.hessian(ene, z0)
    print("E(N2):", float(e))
    print("dE/dZ:", g.cpu().numpy())
    print("d2E/dZ2:", h.cpu().numpy())
    return g, h


if __name__ == "__main__":
    from ._args import parse
    a = parse(__doc__, 0)
    main(a.device)
