"""dqc-tpu-torch: the PyTorch/CUDA port of dqc-tpu for an NVIDIA H100.

Differentiable quantum chemistry in float64. This package is the port of
the JAX package `dqc_tpu` that stands beside it; it imports torch, numpy
and scipy only. Ported so far: molecules, the vendored basis sets, the
one- and two-electron integrals, the integration grid, LDA, GGA and
meta-GGA functionals (hybrids and range-separated hybrids included) and
user-defined (neural) ones (xc/custom.CustomXC), restricted/unrestricted
Hartree-Fock and Kohn-Sham from the SAD start or by direct (variational)
minimisation, external fields and grid-tabulated potentials, derivatives
through the SCF to any order, and the molecular properties built on them
(api/properties.py: Hessians, vibrations, IR and Raman spectra, multipoles,
polarizabilities, geometry optimisation, orbital-Hessian stability).
Two routes for J and K: the dense route, where on the card J and K of
every Fock build, and the long-range K of a
range-separated hybrid, come from a hand-written CUDA kernel
(ops/hopper_jk.py, csrc/ds_jk.cu); and, after mol.densityfit(), the
density-fitted route (scf/df.py: RI-J and RI-K, and an attenuated-metric
fit for the long-range K), which builds no nao^4 tensor. On both the grid
density and V_xc of a GGA or meta-GGA come from two more kernels
(ops/hopper_xc.py, csrc/ds_dens_gga.cu, csrc/ds_vxc_gga.cu). Periodic
solids (Sol) run at the Gamma point: J, K and the nuclear attraction from
analytic pair Fourier transforms with Ewald and Madelung terms, or a
Gaussian fit in the periodic Coulomb metric (sol.densityfit(method="gdf")),
and the XC terms on a cell-wrapped grid through the same two kernels; or
with k-points (Sol(..., kpts=...)): the complex k-point SCF on Bloch pair
transforms and Bloch grid tables (the grid kernels on their real
embedding), k-point exact exchange, and band energies at any k
(band_energies). A batch of geometries of one molecule runs as one SCF
(parallel/batch.energy_batch: the kernels launched once per Fock build
for the batch), theta can be kept on disk between runs (Mol.set_cache,
utils/cache.py), and examples/ holds the runnable examples.

Calculations run on the CUDA card unless the caller passes device="cpu";
without a card and without that argument the entry points raise.
"""
from __future__ import annotations

from ._version import __version__  # noqa: F401
from .api.parser import parse_moldesc            # noqa: F401
from .basis import loadbasis                     # noqa: F401
from .utils.datastruct import (                  # noqa: F401
    SpinParam, ValGrad, CGTOBasis, AtomCGTOBasis)
from .system.mol import Mol                      # noqa: F401
from .system.sol import Sol                      # noqa: F401
from .scf.qccalc import HF, KS, SCF_QCCalc       # noqa: F401
from .scf.fixed_point import SCFOptions          # noqa: F401
from .scf.kpbc import band_energies              # noqa: F401
from .xc import get_xc, get_libxc                # noqa: F401
from .api import properties                      # noqa: F401
from .api.properties import (                    # noqa: F401
    hessian_pos, vibration, ir_spectrum, raman_spectrum, edipole,
    equadrupole, eoctupole, polarizability, optimal_geometry,
    lowest_eival_orb_hessian, is_orb_min)

