"""Basis-set optimisation of H2 (HF/3-21G): Adam on the log-exponents and
contraction coefficients, whose gradients come through the SCF (the port's
examples/02_optimizing_basis.py).

Run: python -m dqc_tpu_torch.examples.02_optimizing_basis [--device cpu]
"""
import torch

import dqc_tpu_torch as dq


def main(device=None, steps=300):
    qc = dq.HF(dq.Mol("H 1 0 0; H -1 0 0", basis="3-21G", device=device))
    p0 = qc._all_params()
    log_a = torch.log(p0["basis"]["alphas"][0]).detach().requires_grad_(True)
    coef = p0["basis"]["coeffs"][0].detach().clone().requires_grad_(True)

    def ene():
        b = dict(p0["basis"], alphas=[torch.exp(log_a)], coeffs=[coef])
        return qc.energy_fn(dict(p0, basis=b))

    print(f"start: E = {float(ene()):.8f}")
    opt = torch.optim.Adam([log_a, coef], lr=5e-2)
    for i in range(steps):
        opt.zero_grad()
        e = ene()
        e.backward()
        opt.step()
        if i % 50 == 0:
            print(f"iter {i}: E = {float(e):.8f}")
    e = float(ene())
    print(f"optimized: E = {e:.8f}")
    print("optimized exponents:", torch.exp(log_a).detach().cpu().numpy())
    return e


if __name__ == "__main__":
    from ._args import parse
    a = parse(__doc__, 300)
    main(a.device, a.steps)
