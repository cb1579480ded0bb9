"""Equilibrium geometry of H2 (HF/3-21G) by Adam on the positions, with
exact forces through the converged SCF (the port's examples/01_equil_pos.py).

Run: python -m dqc_tpu_torch.examples.01_equil_pos [--device cpu]
"""
import torch

import dqc_tpu_torch as dq


def main(device=None, steps=200):
    qc = dq.HF(dq.Mol("H 1 0 0; H -1 0 0", basis="3-21G", device=device))
    p0 = qc._all_params()
    pos = p0["basis"]["atompos"].detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([pos], lr=2e-2)
    for i in range(steps):
        opt.zero_grad()
        e = qc.energy_fn(dict(p0, basis=dict(p0["basis"], atompos=pos)))
        e.backward()
        opt.step()
        if i % 20 == 0:
            print(f"iter {i}: E = {float(e):.8f}  "
                  f"|g| = {float(pos.grad.abs().max()):.2e}")
    print("Equilibrium positions (Bohr):", pos.detach().cpu().numpy())
    print("bond length:", float(torch.linalg.norm(pos[0] - pos[1])),
          "(HF/3-21G H2 eq ~ 1.385 Bohr)")
    return pos.detach()


if __name__ == "__main__":
    from ._args import parse
    a = parse(__doc__, 200)
    main(a.device, a.steps)
