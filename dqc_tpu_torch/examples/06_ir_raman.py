"""Vibrational analysis of H2O (HF/3-21G) from one converged SCF: harmonic
frequencies, IR intensities, Raman activities, dipole and quadrupole, all
exact derivatives through the SCF (the port's examples/06_ir_raman.py).

Run: python -m dqc_tpu_torch.examples.06_ir_raman [--device cpu]
"""
import numpy as np

import dqc_tpu_torch as dq


def main(device=None, steps=0):
    mol = dq.Mol(
        "O 0.0 0.0 0.2156; H 0.0 1.4749 -0.8625; H 0.0 -1.4749 -0.8625",
        basis="3-21G", device=device)
    qc = dq.HF(mol).run()
    print(f"E(HF/3-21G) = {float(qc.energy()):.8f} Ha")
    mu = dq.edipole(qc, unit="debye").cpu().numpy()
    print(f"dipole [D]       = {np.round(mu, 4)}  (CCCBDB: [0, 0, -2.388])")
    quad = dq.equadrupole(qc, unit="debye*angst").cpu().numpy()
    print(f"quadrupole [D*A] = {np.round(np.diag(quad), 3)}  "
          f"(CCCBDB: [-6.838, -3.972, -5.882])")
    freqs, ir_ints = dq.ir_spectrum(qc, ints_unit="km/mol")
    _, raman = dq.raman_spectrum(qc, ints_unit="angst^4/amu")
    print("\n  mode   freq [cm^-1]   IR [km/mol]   Raman [A^4/amu]")
    for i in range(3):
        print(f"  {i + 1:4d}   {float(freqs[i]):12.1f} "
              f"{float(ir_ints[i]):13.3f} {float(raman[i]):17.2f}")
    print("\nCCCBDB HF/3-21G: 3944/3811/1800 cm^-1, "
          "IR 9.12/0.05/79.9 km/mol, Raman 44.1/95.7/11.5 A^4/amu")
    return freqs


if __name__ == "__main__":
    from ._args import parse
    a = parse(__doc__, 0)
    main(a.device)
