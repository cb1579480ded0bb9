"""Periodic solids: Gamma-point and k-point Kohn-Sham and HF, forces
through the periodic SCF and band energies (the port's
examples/05_pbc_solid.py).

Run: python -m dqc_tpu_torch.examples.05_pbc_solid [--device cpu]
(minutes on the CPU: the "sg2" grids' Becke weights)
"""
import numpy as np

import dqc_tpu_torch as dq


def main(device=None, steps=0):
    a = 3.0  # Bohr
    # gamma point: H simple cubic, unrestricted LDA
    sol = dq.Sol("H 0 0 0", np.eye(3) * a, basis="3-21G", spin=1,
                 grid="sg2", device=device)
    qc = dq.KS(sol, xc="lda_x").run()
    print("H sc LDA energy per cell:", float(qc.energy()))
    force = -qc.energy_grad()["basis"]["atompos"]
    print("force on atom (symmetry -> ~0):", force.cpu().numpy())
    # k-point sampling: He, 2-point mesh
    kpts = np.array([[0.0, 0.0, 0.0], [np.pi / a, 0.0, 0.0]])
    sol_k = dq.Sol("He 0 0 0", np.eye(3) * a, basis="sto-3g", grid="sg2",
                   kpts=kpts, device=device)
    qc_k = dq.KS(sol_k, xc="gga_x_pbe").run()
    print("He sc PBE, 2 k-points:", float(qc_k.energy()))
    qc_hf = dq.HF(sol_k).run()
    print("He sc HF, 2 k-points:", float(qc_hf.energy()))
    # band structure along Gamma-X from the converged PBE Hamiltonian
    kline = np.stack([np.linspace(0, np.pi / a, 5), np.zeros(5),
                      np.zeros(5)], axis=1)
    bands = dq.band_energies(qc_k, kline)
    print("lowest band along Gamma-X:", bands[:, 0].cpu().numpy())
    return float(qc.energy())


if __name__ == "__main__":
    from ._args import parse
    a = parse(__doc__, 0)
    main(a.device)
