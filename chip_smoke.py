#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three hand-written CUDA kernels of the port from the sources in
this checkout (K1 ds_jk, K2 ds_dens_gga, K3 ds_vxc_gga; one nvcc per source,
all started together), holds each against its plain PyTorch version on the
card, drives the port's paths through the entry points a user calls (`Mol`,
`HF`/`KS`, `SCF_QCCalc.run`, `energy_grad`) and checks what comes out
against JAX-CPU anchors: restricted Hartree-Fock and B3LYP Kohn-Sham on
benzene/def2-SVP (nao = 114; grid level 2, 78,144 points) from the SAD
start, and their forces; CAM-B3LYP (long-range exchange through K1 on the
erf-attenuated ERI), SCAN (a meta-GGA) and a neural CustomXC with its
parameter gradient on the same molecule; B3LYP on vitamin C/def2-SVP (nao
= 208, the dense route past nao 128); then the density-fitted route
(`mol.densityfit()`, autoaux): B3LYP and CAM-B3LYP on benzene against
JAX-CPU anchors, its forces, the reference's vitamin C workload (LDA), a
benzene dimer (nao 228) whose dense ERI does not fit the dense route, and
the O2 triplet (UKS-LDA) against PySCF; then the exact routes past the
dense limit (the canonical quartet blocks of scf/jk.py cached, or streamed
on every Fock build): B3LYP on benzene and its forces, and on vitamin C,
against the dense route in the same run, the streamed route on benzene, and
the dimer without densityfit(); then the property API's second and third
derivatives of the energy through the SCF (HF H2O/3-21G against CCCBDB and
the JAX package, B3LYP H2O/def2-SVP against central differences, the
polarizability and multipoles of benzene) and the variational SCF (H2O,
and benzene B3LYP against its DIIS energy); then periodic cells at the
Gamma point (`Sol`, the simple-cubic H lattice of edge 3 Bohr, 3-21G, grid
"sg2"): UKS-PBE of its 3x3x3 supercell H27 (nao 54, 664,012 wrapped grid
points) on the pair-transform route, K2 and K3 at that shape, and the 2x2x2
supercell H8 (HF, PBE, PBE0, CAM-B3LYP, the periodic fit) against JAX-CPU
anchors, with its forces; then periodic cells with k-points (`Sol(...,
kpts=...)`, scf/kpbc.py): RKS-PBE of H8 on the Gamma-centred 3x3x3 mesh (27
k-points; K2 and K3 once per k-point per Fock build on the real embedding of
the Bloch tables, (195,894, 32)), with `band_energies`, Bloch's theorem
against the Gamma path on the tripled supercell H24, every k-point route on
H8's three-point mesh against JAX-CPU anchors, PBE0 on the 2x2x2 mesh, and
the forces of a small k-point cell; and the batch axis
(`parallel/batch.energy_batch`): 8 geometries of benzene with a neural
CustomXC through one batched SCF (K1-K3 once per Fock build for the
batch), its loss gradient, and K1-K3 with a batch axis against their plain
versions; the on-disk theta cache (`Mol.set_cache`) and purification
(`scf/purify.py`) on benzene; and a batch on every route: two H8 cells on
the 3x3x3 mesh through one batched k-point SCF (K2 and K3 27 times per
batched Fock build, each launch over strided views of both members'
tables, and held there against their plain versions and against the call
on a contiguous copy), two H8 cells at the Gamma point (PBE on the pair
transforms, PBE0 on the periodic fit, the HF position gradient of their
sum), and two benzene geometries on the blocked and streamed routes and by
the variational solver, each member against its unbatched calc. Any
failed check or exception
ends the run with a non-zero exit code. Without a CUDA device it fails at once and
prints no result.

One JSON object per line: `device`, the card's name and power limit as
nvidia-smi prints them, `build`, `kernel_checks`, `main_path` (HF),
`eri_dense`, `eigh`, `xc_kernel_checks`, `main_path_ks` (with the SCF
iterations from SAD and from GWH on the same theta, the seconds of the
atomic SCFs), `ks_kernel_checks`, `ds_dens_gga_plan`, `ds_vxc_gga_plan`
and `ds_jk_plan` (the launch plans of K2, K3 and K1 at the main path's
shapes), `ks_iteration_ms`, `ks_iteration_profile` (one KS iteration under
torch.profiler: device time by kernel, the card's idle share),
`kernel_backward_checks` (each kernel's autograd backward against the plain
version's, with launch counts, and one double backward), `forces` (benzene
B3LYP forces by implicit differentiation against
tools/.force_cpu_def2-svp.npz: |dE|, max|dF| against the stored forces'
mirror-symmetric part and raw, the forces' mirror gap, the grid's, |sum F|,
seconds, GMRES records, launches inside the gradient, peak memory, and
whether the calc outlives the phase once dropped: calc_alive_after_grad),
`forces_fd` (central differences of the energy on the card), `cam_b3lyp`
(with K1 on the erf tensor against its plain version and one steady
iteration under the profiler), `meta_gga` (SCAN on benzene, and the PySCF
anchors of SCAN exchange on CO and Li2), `nn_xc` (the parameter gradient
against central differences), `vitamin_c`, `df_b3lyp`, `df_cam_b3lyp`
(each with `parts`: the device time of RI-J, RI-K, K2, K3 and eigh at the
converged dm, each under torch.profiler), `df_forces` and `df_forces_fd`,
`df_vitamin_c`, `df_beyond_dense` (K2/K3 at nao 228 against their plain
versions), `df_uks_o2`, `blocked_b3lyp` (J and K against K1's on the dense
eri_k, and a repeat of them bit for bit), `blocked_forces`,
`stream_b3lyp`, `blocked_vitamin_c` (beside `vitamin_c`: the block build's
seconds against eri_dense's, the peaks, the allocator's retries and the
bra blocks coulomb_contract chose in both), `blocked_beyond_dense`,
`variational_benzene` (the "ov" variational SCF on the main path's theta),
`props_h2o_hf`, `props_h2o_b3lyp` and `props_benzene` (each property
call's launches and seconds apart, the forward/backward/column seconds and
GMRES records of each derivative, peaks), `pbc_h27_pbe` (stage seconds:
the lattice sums, the pair transforms, the Becke weights and the AO
tables apart, the SCF; iterations, the idle share of a steady iteration,
launches, peak; the grid's electron count; K2/K3 at (664012, 54) against
their plain versions and timed beside their bound; a second SCF on the same
theta and a second pair-transform build against the first, bit for bit),
`pbc_h8_hf` (exxdiv "ewald" and None), `pbc_h8_pbe`, `pbc_h8_pbe0`,
`pbc_h8_camb3lyp`, `pbc_h8_gdf_pbe`, `pbc_h8_gdf_camb3lyp`,
`pbc_h8_forces` with `pbc_h8_forces_fd[hf]` and `[pbe]`, `pbc_k_h8_pbe`
(stage seconds, iterations, the idle share of a steady iteration,
launches, peak, the reckoned sizes beside the measured ones, the grid's
electron count, K2/K3 on two embedded tables against their plain versions
and timed beside their bound, a second SCF on the same theta bit for bit,
band energies at mesh points against the SCF's eigenvalues and at k against
-k), `pbc_k_bloch` (HF, k-mesh and H24 records and their
difference per cell), `pbc_k_h8_3mesh_*` (HF with exxdiv "ewald" and None,
PBE, PBE0, CAM-B3LYP, SCAN, UKS-PBE, the k-point fit with PBE),
`pbc_k_h8_pbe0_222` (with the exchange stack's bytes and the band
energies at an off-mesh k against -k), `pbc_k_forces` with
`pbc_k_forces_fd[hf]` and `[pbe]`, `batch_nnxc` (8 benzene geometries in one
batched SCF: stage seconds, iterations per member, launches per batched
Fock build, the loss gradient against central differences, members 0 and
7 against the unbatched energy_fn, a steady batched iteration under the
profiler, and K1-K3 at B = 1, 3, 8 against their plain versions with
their B = 8 times), `cache_benzene` (two runs through set_cache: the parts
loaded, theta_s, the energies and gradients bit for bit),
`purify_benzene` (purification against eigh), `batch_kpbc` (B = 2
H8 cells on the 3x3x3 mesh: stage seconds, iterations per member,
launches per batched Fock build, a steady batched iteration under the
profiler, the peak, member 0 against `pbc_k_h8_pbe` and member 1 against
its unbatched energy_fn, and `kernel_checks_strided`/`kernels_strided`:
K2/K3 on the members' tables at one k-point, a strided view, against the
plain version and a contiguous copy, timed beside the bound and one
PyTorch call), `batch_pbc_gamma` (two H8 cells: `pbe`, `pbe0_gdf` and
`hf_gradient`), `batch_blocked`, `batch_stream` and `batch_variational`
(two benzene geometries each; BFGS iterations and evaluations, launches
per batched energy), `small`,
`kernels` (K2's and K3's rows also have their times at H27's shape,
`pbc_h27`, and at the k-point main path's embedded shape,
`pbc_k_h8_embedded`; K3's row
also has its registers and spills from this run's ptxas report; every row
its launches on every path, K1's also on the erf tensor: each path's own
SCF, with those of the atomic SCFs of its SAD start apart; and those inside
the second- and third-order property calls and the variational SCFs, and
per batched Fock build on each batch path; K2's and K3's rows their
strided k-point view's check and time, `strided_kpoint_view`), and
as the last
line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports the port only; nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time
import weakref
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; "
                     "this script needs one CUDA device\n")
    sys.exit(2)

import dqc_tpu_torch as dq                                    # noqa: E402
from dqc_tpu_torch.api import properties as P                 # noqa: E402
from dqc_tpu_torch.ops import (                               # noqa: E402
    _nvcc, eri, hopper_jk, hopper_xc, integrals)
from dqc_tpu_torch.ops.hopper_jk import (                     # noqa: E402
    ds_jk, ds_jk_kplanes, ds_jk_reference)
from dqc_tpu_torch.ops.hopper_xc import (                     # noqa: E402
    ds_dens_gga, ds_dens_reference, ds_vxc_gga, ds_vxc_reference)
from dqc_tpu_torch.scf import kpbc, qccalc                   # noqa: E402
from dqc_tpu_torch.scf.df import df_j, df_k                  # noqa: E402
from dqc_tpu_torch.scf.eigh import safe_eigh                  # noqa: E402
from dqc_tpu_torch.xc import integrate                        # noqa: E402

DEV = torch.device("cuda", 0)

# data-sheet peaks of the H100 SXM: device memory rate, and the float64
# rate of the tensor cores (the vector units do half of it); the bound uses
# the larger rate so that it stays a lower bound on the time
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12

GATE_REL = 1e-10          # each kernel against its plain version
# JAX-CPU value of dqc_tpu.HF(benzene/def2-svp, SCFOptions(mixed=False)),
# same geometry, converged to a residual of 9e-10 (float64, x86-64 host)
HF_ANCHOR_HA = -230.5357956254473
# JAX-CPU value of dqc_tpu.KS(benzene/def2-svp, grid=2, "b3lyp"), the
# energy bench.py records; a fresh run of dqc_tpu.KS(..., SCFOptions(
# mixed=False)) on an x86-64 host gave -232.08457237792118 (2e-12 from it)
KS_ANCHOR_HA = -232.08457237792322
KS_GATE_HA = 1e-8
NELEC = 42
# sum_g dvol rho of the converged density on the level-2 grid: the grid
# integrates benzene's 42 electrons to 3.8e-4 (its quadrature error); the
# same dqc_tpu.KS run gave this value on the JAX package's own grid
KS_NELEC_GRID_JAX = 41.999618601085785
H2_ANCHOR_HA = -1.07195346   # RHF H2/3-21G, d = 1.0 a0 (PySCF)
# JAX-CPU values of dqc_tpu.KS(benzene/def2-svp, grid=2, xc, SCFOptions(
# mixed=False)), same geometry, float64 on an x86-64 host, made by
#   JAX_PLATFORMS=cpu python tests/torch_anchor_report.py camb3lyp scan nnxc
# CAM-B3LYP: 597 s, final residual 1.6e-9, the JAX package's dense route
# (the script raises its dense limit: its blocked route refuses exx_lr)
CAM_ANCHOR_HA = -231.9410095912526
# SCAN (mgga_x_scan + mgga_c_scan): 284 s, final residual 2.3e-9
SCAN_ANCHOR_HA = -231.96826641400787
# the neural CustomXC of nn_params_np/nn_edens below: 356 s, residual 3.3e-9
NN_ANCHOR_HA = -227.06712708493444
# PySCF anchors of SCAN exchange alone, 6-311++G** (tests/test_scf.py:73,
# :109-114): CO at grid 3 to 1.3e-3 Ha, Li2 at grid 4 to 1e-4 Ha
SCAN_PYSCF = (("C -1.0 0 0; O 1.0 0 0", 3, -112.836255, 1.3e-3),
              ("Li -2.5 0 0; Li 2.5 0 0", 4, -14.8687500, 1e-4))
KS_PLAIN_GATE_HA = 1e-9   # kernel path against plain path, same dm
# central differences of the NN energy in its parameters: h and the gate
NN_FD_STEP = 1e-4
NN_FD_GATE_REL = 1e-6
NN_SEED = 8
# L-ascorbic acid, 20 atoms, Bohr (benchmarks/vitamin_c.py:16-36)
VITAMIN_C = """O 0.1761 -2.0912 1.2179; O -2.5390 0.1686 -2.6197;
O 1.5859 4.5166 0.5374; O -7.3565 -0.3855 -0.6285;
O 5.7108 1.0762 -1.1444; O 3.7634 -4.0742 -0.2600;
C -0.6419 0.4947 1.4840; C -3.0347 0.8664 -0.0624;
C 1.5518 1.9398 0.5456; C -5.1899 -0.7714 0.9190;
C 3.4161 0.4295 -0.1982; C 2.5579 -2.1696 0.2094;
H -0.9740 0.8710 3.4930; H -3.6211 2.8520 -0.0816;
H -4.7222 -2.7845 0.8222; H -5.6716 -0.2763 2.8684;
H -2.0785 -1.6104 -2.6430; H 0.0074 5.0941 1.2812;
H -8.6971 -1.4445 0.0486; H 6.6186 -0.4860 -1.4846"""
VITAMIN_C_NELEC = 92
# the basis of the dense and blocked vitamin C phases (nao 208)
VITC_BASIS = "def2-svp"
# the density-fitted route (mol.densityfit(), the generated autoaux basis,
# naux = 1308 for benzene): JAX-CPU values of dqc_tpu.KS(benzene/def2-svp,
# grid=2, xc, SCFOptions(mixed=False)) after mol.densityfit(), same
# geometry, float64 on an x86-64 host, made by
#   JAX_PLATFORMS=cpu python tests/torch_anchor_report.py --factored \
#       df_b3lyp df_camb3lyp df_vitc
# --factored: the JAX package's own pseudo-inverse fit, contracted in
# factored form. Its df_j/df_k contract j3c with the explicit v_inv and lose
# about eps * cond(j2c) to cancellation (ROADMAP queue C): without the flag
# its B3LYP energy is 1.27e-5 Ha lower and its DIIS stops at a residual of
# 2.8e-8, above its tol (451 s); the *_OWN_FIT_HA values are those runs,
# recorded beside the gate, not gated.
# B3LYP: 370 s, final residual 2.6e-9
DF_ANCHOR_HA = -232.08457809495974
DF_ANCHOR_OWN_FIT_HA = -232.08459083164493
# CAM-B3LYP: 455 s, final residual 1.6e-9
DF_CAM_ANCHOR_HA = -231.94101590265686
# CAM-B3LYP without --factored: 496 s, its DIIS stopped at 7.4e-5
DF_CAM_ANCHOR_OWN_FIT_HA = -231.94102981241718
# vitamin C/cc-pVDZ, grid 2, densityfit(), lda_x+lda_c_pw (naux 2778,
# metric ratio 7.6e-12): 578 s, final residual 3.5e-9
VITC_DF_ANCHOR_HA = -679.4797900665019
# what JAX_PLATFORMS=cpu python benchmarks/vitamin_c.py prints (the JAX
# package's own harness, unedited: its own fit, its default options)
VITC_DF_HARNESS_HA = -679.4798035743
VITC_DF_GATE_HA = 1e-7
# the second benzene of the dimer, shifted along z (Bohr). At this distance
# the two still interact through their quadrupoles: coaxial, E_QQ =
# 6 Theta_zz^2 / R^5 (Buckingham), 7.1e-7 Ha for B3LYP/STO-3G's Theta_zz =
# -3.49 ea0^2, where E_dimer - 2 E_monomer on the DF route on the CPU is
# 6.4e-7 Ha (1.9e-8 at 80 Bohr, against 2.2e-8: the R^-5 law). The gate
# holds E_dimer - 2 E_monomer - E_QQ, with Theta_zz of the monomer's own
# density, to DIMER_GATE_HA.
DIMER_SHIFT_BOHR = 40.0
DIMER_GATE_HA = 1e-6
# O2 triplet, UKS-LDA on the DF route against PySCF (tests/test_scf.py:
# test_uks_o2_df_anchor; the reference fits in def2-svp-jkfit, the port in
# autoaux, and the gate covers both)
O2_DF_PYSCF = ("O -1 0 0; O 1 0 0", "6-311++G**", 3, -149.259475, 1.3e-3)
# what stats holds for the DF route (scf/qccalc._make_theta)
DF_STATS = ("df_s", "coul2c_s", "coul3c_s", "coul3c_classes", "factor_s",
            "naux", "metric_ratio", "naux_kept", "df_lr_s", "df_lr")
# and for the blocked and streamed routes
EXACT_STATS = ("jk_blocks_s", "jk_blocks_bytes", "jk_combos", "jk_facs_s",
               "warm_df_s", "warm_naux")
# the blocked route against the dense one in the same run: energies (Ha),
# J and K at one dm against K1's on eri_k (relative to the largest entry),
# forces (Ha/Bohr) and their mirror gap; the streamed route's energy
BLOCKED_E_GATE_HA = 1e-9
BLOCKED_JK_GATE_REL = 1e-10
BLOCKED_FORCE_GATE = 1e-9
BLOCKED_MIRROR_GATE = 1e-10
STREAM_E_GATE_HA = 1e-8

ANGSTROM_TO_BOHR = 1.0 / 0.529177210903

# periodic cells at the Gamma point: the simple-cubic H lattice of edge
# PBC_A (BASELINE.md:18, tests/test_pbc.py:89-103), 3-21G, grid "sg2".
# H27, its 3x3x3 supercell (a 9-Bohr cube; nao 54), is the main path of the
# periodic slice: UKS-PBE (27 electrons, spin 1) on the pair-transform
# route. Its grid integrates the density to PBC_NELEC_GATE per cell: the
# 1e-3 per-cell count error of this grid on the one-atom cell
# (dqc_tpu/grid/factory.py:218-224, tests/test_pbc.py:64-86)
PBC_A = 3.0
PBC_NELEC_GATE = 1e-3
H27_SHAPE = (664012, 54, 772)        # grid points, nao, virtual atoms
# H8, the 2x2x2 supercell (a 6-Bohr cube; nao 16), restricted: JAX-CPU
# values of dqc_tpu.HF/KS(Sol(H8, 6 eye(3), "3-21g", grid="sg2"),
# SCFOptions(mixed=False)), float64 on an x86-64 host, made by
#   JAX_PLATFORMS=cpu python tests/torch_anchor_report.py pbc_h8_hf \
#       pbc_h8_pbe pbc_h8_pbe0 pbc_h8_camb3lyp
# (196 s and 289 s for the two HF runs, 332, 335, 408 s for the KS ones,
# three runs side by side on one host)
PBC_H8_ANCHORS_HA = {"hf": -4.148790611055139,
                     "hf_exxdiv_none": -2.2572589580680598,
                     "pbe": -4.213428884296103,
                     "pbe0": -4.256544754343853,
                     "camb3lyp": -4.311594509885233}
# the periodic fit (densityfit(method="gdf"), autoaux), made by
#   JAX_PLATFORMS=cpu python tests/torch_anchor_report.py --factored \
#       pbc_h8_gdf_pbe pbc_h8_gdf_camb3lyp
# (335 s, 415 s). --factored contracts the JAX package's pseudo-inverse fit
# in factored form, as the port does; without it its explicit v_inv loses
# eps * cond to cancellation (the *_OWN_FIT values: 1.5e-11 and 3.7e-9 Ha
# from the factored ones; recorded beside the gate, not gated)
PBC_H8_GDF_ANCHORS_HA = {"pbe": -4.213429145404201,
                         "camb3lyp": -4.310477072837884}
PBC_H8_GDF_OWN_FIT_HA = {"pbe": -4.213429145389235,       # 247 s
                         "camb3lyp": -4.310477076569724}  # 260 s
PBC_GATE_HA = 1e-8
# forces of a distorted H8 (atom 1 moved by PBC_DISTORT Bohr) against central
# differences of the same energy_fn (the grid's wrapping and images are
# frozen at the cell's construction, so both sides see the same function)
PBC_DISTORT = (0.21, -0.13, 0.08)
PBC_FD_COMPONENTS = {"hf": ((1, 0), (1, 1), (5, 2)), "pbe": ((1, 0),)}
# periodic cells with k-points (scf/kpbc.py). The main path: RKS-PBE of H8 on
# the Gamma-centred 3x3x3 Monkhorst-Pack mesh (27 k-points), the same
# crystal as an H216 supercell at Gamma. Its reckoned sizes: 98,900 G
# (H27's 333,715 x 8/27), Qre and Qim 10.9 GB together, about 197k wrapped
# points (H27's 664,012 x 8/27) and 5.4 GB of embedded Bloch tables
K_MAIN_MESH = (3, 3, 3)
K_MAIN_SHAPE = (27, 16)                    # k-points, nao
K_BAND_GATE_HA = 1e-10     # band energies against the SCF's eigenvalues
K_TRACE_GATE = 1e-8        # sum_k w_k tr(D^k S^k) = N
# Bloch's theorem at complex phases: H8 on a 3x1x1 mesh against the Gamma
# path on the tripled supercell H24 (18 x 6 x 6 Bohr), per H8 cell, at the
# tolerances of tests/test_pbc.py:256-269 (HF) and :410-441 (LDA; here PBE):
# the wrapped grids of the two cells differ
K_BLOCH_GATES_HA = {"hf": 1e-6, "pbe": 5e-6}
# H8 on the three-point mesh k = (n pi / 9, 0, 0) Bohr^-1, n = 0, 1, 2 (the
# two-point mesh along x does not converge: with the same occupations at
# every k, the JAX package's own PBE SCF there stops at a residual of 3e-2):
# JAX-CPU values of dqc_tpu.HF/KS(Sol(H8, 6 eye(3), "3-21g", grid="sg2",
# kpts=the mesh), SCFOptions(mixed=False)), float64 on an x86-64 host,
# made by
#   JAX_PLATFORMS=cpu python tests/torch_anchor_report.py pbc_k3_hf \
#       pbc_k3_pbe pbc_k3_pbe0 pbc_k3_camb3lyp pbc_k3_scan pbc_k3_uks_pbe
#   JAX_PLATFORMS=cpu python tests/torch_anchor_report.py --factored \
#       pbc_k3_gdf_pbe
# (the fit held to the JAX package's k-point fit contracted in factored
# form, as the port's is; the seconds of each run, two or three side by
# side on one host, beside it)
PBC_K3_ANCHORS_HA = {"hf_ewald": -3.8873836286496077,      # 4070 s
                     "hf_none": -3.3816021524510154,       # 3780 s
                     "pbe": -4.21935798374394,             # 587 s
                     "pbe0": -4.198261494509878,           # 4045 s
                     "scan": -4.222619361855116,           # 572 s
                     "uks_pbe": -4.21935798374394,         # 615 s
                     "gdf_pbe": -4.219656531138137,        # 574 s
                     "camb3lyp": -4.163696202459419}       # 3267 s
# the k-point force cell: H2 in a 3-Bohr cube, 3-21G, grid "sg2", the
# two-point mesh along x; central differences of the same energy_fn at
# these (atom, axis) components. jax.grad of the JAX package's k-point
# energy_fn on this cell does not fit a 62 GB host (its HF gradient was
# killed at 34.5 GB), so no JAX value is stored
K_FORCE_DESC = "H 0.1 -0.05 0.02; H 1.45 0.12 -0.1"
# the hybrid on the 2x2x2 mesh: H8's cell (6 Bohr, 3-21G, "sg2") with its
# atoms paired into H2 along x, at these x (Bohr). The same sizes as H8
# (nao 16, 98,985 G, a 25.9 GB exchange stack); H8 itself is a metal there,
# and with the same occupations at every k its PBE0 SCF stalls at a residual
# of 1.3e-7 (PBE: 5e-2)
K_PAIRED_X = (0.8, 2.2)
K_FORCE_MESH = ((0.0, 0.0, 0.0), (np.pi / 3.0, 0.0, 0.0))
K_FORCE_COMPONENTS = ((0, 0), (1, 1), (1, 2))


@contextmanager
def route_limits(dense=None, blocked=None):
    """config's byte limits of the dense and blocked routes set for the
    phase inside (the route is chosen when HF/KS is called, the SAD atoms'
    when run() starts them), and restored after it."""
    cfg = qccalc.config
    old = (cfg.DENSE_ERI_BYTES_LIMIT, cfg.BLOCKED_JK_BYTES_LIMIT)
    try:
        if dense is not None:
            cfg.DENSE_ERI_BYTES_LIMIT = dense
        if blocked is not None:
            cfg.BLOCKED_JK_BYTES_LIMIT = blocked
        yield
    finally:
        cfg.DENSE_ERI_BYTES_LIMIT, cfg.BLOCKED_JK_BYTES_LIMIT = old


# the bra blocks coulomb_contract's _auto_block chose since the list was
# cleared: (bra pairs n, rows per block)
_AUTO_BLOCKS = []


def _record_auto_block(auto_block):
    def recorded(n, *args):
        b = auto_block(n, *args)
        _AUTO_BLOCKS.append((n, b))
        return b
    return recorded


def auto_blocks():
    """[[n, rows per block, calls], ...] since _AUTO_BLOCKS was cleared."""
    return [[n, b, c] for (n, b), c in sorted(Counter(_AUTO_BLOCKS).items())]


def free_device():
    """Frees what the last phase left on the card before the next one reads
    its peak. The collection is hygiene: nothing of the port is known to
    outlive its phase in a reference cycle (the forces phase checks that
    its calc is freed when dropped, before any collection)."""
    gc.collect()
    torch.cuda.empty_cache()


def alloc_retries():
    """The caching allocator's count of cudaMalloc retries (after freeing
    its cache) since the process started."""
    return torch.cuda.memory_stats().get("num_alloc_retries", 0)


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


def benzene_desc():
    rcc = 1.39 * ANGSTROM_TO_BOHR
    rch = (1.39 + 1.09) * ANGSTROM_TO_BOHR
    atoms = []
    for i in range(6):
        a = np.pi / 3 * i
        atoms.append(f"C {rcc*np.cos(a):.10f} {rcc*np.sin(a):.10f} 0.0")
        atoms.append(f"H {rch*np.cos(a):.10f} {rch*np.sin(a):.10f} 0.0")
    return "; ".join(atoms)


def eri_like(n, seed):
    """Seeded tensor with the magnitudes and the (ij|kl) symmetries of an
    ERI tensor; the numbers come from numpy, the symmetrisation runs on the
    card."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n, n, n)) * np.exp(
        rng.uniform(-8, 1, (n, n, n, n)))
    t = torch.as_tensor(t, device=DEV)
    t = t + t.permute(1, 0, 2, 3)
    t = t + t.permute(0, 1, 3, 2)
    t = t + t.permute(2, 3, 0, 1)
    return t.contiguous()


def card_like(n, seed):
    """Seeded (n,n,n,n) tensor with an ERI's spread of magnitudes and no
    symmetry, made on the card from a torch.Generator (numpy on the host
    is too slow at these sizes: 4 GB at n = 150, 6.8 GB at n = 171)."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    t = torch.randn((n,) * 4, generator=g, dtype=torch.float64, device=DEV)
    scale = torch.empty_like(t).uniform_(-8.0, 1.0, generator=g)
    return t.mul_(scale.exp_())


def sym_dm(n, seed):
    rng = np.random.default_rng(seed)
    dm = rng.standard_normal((n, n))
    return torch.as_tensor(dm + dm.T, device=DEV)


def check_kernel(T, dm, label):
    """Kernel against the plain version on the same tensors; twice, to see
    that the result repeats bit for bit. Returns the record."""
    out1 = ds_jk(T, dm)
    out2 = ds_jk(T, dm)
    ref = ds_jk_reference(T, dm)
    torch.cuda.synchronize()
    rec = {"case": label, "n": T.shape[0]}
    for name, a, b, r in (("trail", out1[0], out2[0], ref[0]),
                          ("mid", out1[1], out2[1], ref[1])):
        scale = float(r.abs().max())
        err = float((a - r).abs().max())
        rec[f"{name}_max_abs_err"] = err
        rec[f"{name}_rel_err"] = err / scale
        rec[f"{name}_bit_identical"] = bool(torch.equal(a, b))
        if not (err / scale <= GATE_REL):
            fail(f"ds_jk {label}: {name} rel err {err / scale:.3e} "
                 f"> {GATE_REL}")
        if not torch.equal(a, b):
            fail(f"ds_jk {label}: {name} differs between two launches")
    return rec


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def xc_tables(ng, nao, seed):
    """Seeded AO-like tables with a wide spread of magnitudes (the
    generator of tests/test_pallas_xc.py); numbers from numpy."""
    rng = np.random.default_rng(seed)
    ao = rng.standard_normal((ng, nao)) * np.exp(rng.uniform(-6, 2, (ng, nao)))
    ag = rng.standard_normal((3, ng, nao)) * np.exp(
        rng.uniform(-6, 2, (3, ng, nao)))
    return torch.as_tensor(ao, device=DEV), torch.as_tensor(ag, device=DEV)


def _compare(rec, name, a, b, r, label, kernel):
    scale = float(r.abs().max())
    err = float((a - r).abs().max())
    rec[f"{name}_max_abs_err"] = err
    rec[f"{name}_rel_err"] = err / scale
    rec[f"{name}_bit_identical"] = bool(torch.equal(a, b))
    if not (err / scale <= GATE_REL):
        fail(f"{kernel} {label}: {name} rel err {err / scale:.3e} "
             f"> {GATE_REL}")
    if not torch.equal(a, b):
        fail(f"{kernel} {label}: {name} differs between two launches")


def check_dens(ao, ag, dm, label):
    """K2 against its plain version, launched twice."""
    out1 = ds_dens_gga(ao, ag, dm)
    out2 = ds_dens_gga(ao, ag, dm)
    ref = ds_dens_reference(ao, ag, dm)
    torch.cuda.synchronize()
    rec = {"case": label, "ng": ao.shape[0], "nao": ao.shape[1]}
    for name, a, b, r in (("rho", out1[0], out2[0], ref[0]),
                          ("gdot", out1[1], out2[1], ref[1])):
        _compare(rec, name, a, b, r, label, "ds_dens_gga")
    return rec


def check_vxc(ao, ag, vr, vg, label):
    """K3 against its plain version, launched twice."""
    v1 = ds_vxc_gga(ao, ag, vr, vg)
    v2 = ds_vxc_gga(ao, ag, vr, vg)
    ref = ds_vxc_reference(ao, ag, vr, vg)
    torch.cuda.synchronize()
    rec = {"case": label, "ng": ao.shape[0], "nao": ao.shape[1]}
    _compare(rec, "v", v1, v2, ref, label, "ds_vxc_gga")
    return rec


def time_turns(kernel, plain, reps=20):
    """(kernel runs, plain runs) in turns: plain, kernel, kernel, plain."""
    p1 = time_ms(plain, reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, reps)
    return [k1, k2], [p1, p2]


def ptxas_summary(log):
    """Registers, spills and static shared memory of each kernel in a
    ptxas -v report."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def bound(bytes_moved, flops):
    b = bytes_moved / HBM_BYTES_PER_S * 1e3
    o = flops / FP64_FLOP_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


# benzene B3LYP/def2-SVP forces of the JAX package on an x86-64 host
# (tools/tpu_force_demo.py --save, tol 1e-11, the 1e-12 density screen)
FORCE_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", ".force_cpu_def2-svp.npz")
# The molecule, its grid and the Becke weights are symmetric under x -> -x
# and y -> -y (checked below), so exact forces are too. The stored forces
# break both mirrors by 8.3e-5 Ha/Bohr: the JAX package's eigenvector rule
# multiplies the rounding of degenerate orbital pairs by 1/(their split),
# a split the SCF leaves at rounding level. The port's forces are held to the
# mirror-symmetric part of the stored forces (the average over the four
# images) and to their own mirror images, both to 1e-8 Ha/Bohr; the raw
# gap is printed beside them.
FORCE_GATE = 1e-8
MIRROR_GATE = 1e-8
GRID_SYM_GATE = 1e-12     # mirror images of the grid: Bohr, and rel. weight
FORCE_E_GATE = 1e-9       # |dE| in Ha
# central differences of the energy on the card, h = 1e-4 Bohr: their own
# error is the truncation (2.6e-9 Ha/Bohr for benzene HF/STO-3G on the
# CPU) plus the energy's rounding over 2h (1e-12 Ha -> 5e-9)
FD_STEP = 1e-4
FD_GATE = 1e-7
FD_COMPONENTS = ((0, 1), (2, 0), (3, 1))   # (atom, axis); atom 0's y is 0
GRAD_GATE_REL = 1e-10     # kernel backward against the plain backward


def _launch_counts():
    return {"ds_jk": ds_jk.launches, "ds_dens_gga": ds_dens_gga.launches,
            "ds_vxc_gga": ds_vxc_gga.launches}


def _grads(fn, inputs, bars):
    """autograd.grad of sum <out, bar> in every input."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    dot = sum((o * b).sum() for o, b in zip(outs, bars))
    return torch.autograd.grad(dot, inputs)


def check_backward(name, fn, plain, inputs, label):
    """The Function's backward on the card (kernels) against autograd of
    the plain version on the same inputs; twice, bit for bit."""
    inputs = [t.detach().requires_grad_(True) for t in inputs]
    with torch.no_grad():
        outs = plain(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=DEV)
    g.manual_seed(5)
    bars = [torch.randn(o.shape, generator=g, dtype=o.dtype, device=DEV)
            for o in outs]
    before = _launch_counts()
    got = _grads(fn, inputs, bars)
    again = _grads(fn, inputs, bars)
    ref = _grads(plain, inputs, bars)
    torch.cuda.synchronize()
    after = _launch_counts()
    rec = {"case": label, "kernel": name,
           "launches": {k: after[k] - before[k] for k in after}}
    for i, (a, b, r) in enumerate(zip(got, again, ref)):
        scale = float(r.abs().max())
        err = float((a - r).abs().max())
        rec[f"input{i}_rel_err"] = err / max(scale, 1e-300)
        if not err <= GRAD_GATE_REL * scale:
            fail(f"{name} backward {label}: input {i} rel err "
                 f"{err / max(scale, 1e-300):.3e} > {GRAD_GATE_REL}")
        if not torch.equal(a, b):
            fail(f"{name} backward {label}: input {i} differs between runs")
    return rec


def sym_eri_k(n, seed):
    """eri_like in the exchange layout (eri_k[i,j,k,l] = (ik|jl))."""
    return eri_like(n, seed).permute(0, 2, 1, 3).contiguous()


def kernel_backward_checks(eri_k_benzene):
    recs = []
    n = eri_k_benzene.shape[0]
    for T, label in ((eri_k_benzene, f"benzene eri_k ({n})"),
                     (sym_eri_k(33, 6), "eri_like(33), exchange layout")):
        m = T.shape[0]
        dm = sym_dm(m, 7)
        recs.append(check_backward("ds_jk", ds_jk, ds_jk_reference,
                                   [T, dm], label))
    for ng, nao in ((78144, 114), (3000, 300), (33, 7)):
        ao, ag = xc_tables(ng, nao, seed=nao + 3)
        rng = np.random.default_rng(ng + 3)
        dm = torch.as_tensor(rng.standard_normal((nao, nao)), device=DEV)
        vr = torch.as_tensor(rng.standard_normal(ng), device=DEV)
        vg = torch.as_tensor(rng.standard_normal((3, ng)), device=DEV)
        recs.append(check_backward("ds_dens_gga", ds_dens_gga,
                                   ds_dens_reference, [ao, ag, dm],
                                   f"tables({ng},{nao})"))
        recs.append(check_backward("ds_vxc_gga", ds_vxc_gga,
                                   ds_vxc_reference, [ao, ag, vr, vg],
                                   f"tables({ng},{nao})"))
        del ao, ag
    # one double backward at a small shape: grad of a grad through the
    # kernels against the same through the plain versions
    ao, ag = xc_tables(33, 7, seed=9)
    rng = np.random.default_rng(9)
    dm = torch.as_tensor(rng.standard_normal((7, 7)), device=DEV)
    dd = {}
    for tag, fn in (("kernel", ds_dens_gga), ("plain", ds_dens_reference)):
        d = dm.clone().requires_grad_(True)
        rho, gdot = fn(ao, ag, d)
        (g1,) = torch.autograd.grad((rho ** 2).sum() + (gdot ** 3).sum(), d,
                                    create_graph=True)
        (g2,) = torch.autograd.grad((g1 * g1).sum(), d)
        dd[tag] = g2
    err = float((dd["kernel"] - dd["plain"]).abs().max())
    scale = float(dd["plain"].abs().max())
    recs.append({"case": "double backward, ds_dens_gga (33,7)",
                 "rel_err": err / scale})
    if not err <= GRAD_GATE_REL * scale:
        fail(f"double backward through ds_dens_gga: rel err {err / scale}")
    totals = {k: sum(r.get("launches", {}).get(k, 0) for r in recs)
              for k in ("ds_jk", "ds_dens_gga", "ds_vxc_gga")}
    emit({"kernel_backward_checks": recs, "gate_rel": GRAD_GATE_REL,
          "launches": totals})
    # every backward launched the kernels: K1's dm-cotangent is K1, K2's is
    # K3 and K3's is K2
    if not all(v > 0 for v in totals.values()):
        fail(f"kernel backward launches {totals}")


def mirror_forces(F, axis):
    """Benzene forces (atoms of benzene_desc) mapped by axis -> -axis: the
    C/H pair k at 60k degrees goes to 180 - 60k (x) or -60k (y)."""
    G = np.zeros_like(F)
    for k in range(6):
        j = (3 - k) % 6 if axis == 0 else (-k) % 6
        G[2 * j:2 * j + 2] = F[2 * k:2 * k + 2]
        G[2 * j:2 * j + 2, axis] *= -1
    return G


def symmetric_part(F):
    """The average of benzene forces over the four images of x -> -x and
    y -> -y."""
    return 0.25 * (F + mirror_forces(F, 0) + mirror_forces(F, 1)
                   + mirror_forces(mirror_forces(F, 0), 1))


def grid_mirror_gaps(grid):
    """(max distance of a mirrored grid point to its nearest point, max
    relative weight gap between them) over the mirrors x -> -x, y -> -y."""
    from scipy.spatial import cKDTree
    c = grid["coords"].detach().cpu().numpy()
    w = grid["dvol"].detach().cpu().numpy()
    tree = cKDTree(c)
    dist, wgap = 0.0, 0.0
    for axis in (0, 1):
        m = c.copy()
        m[:, axis] *= -1
        d, j = tree.query(m)
        dist = max(dist, float(d.max()))
        wgap = max(wgap, float(np.abs(w[j] - w).max() / np.abs(w).max()))
    return dist, wgap


def forces(smi_line):
    """Benzene B3LYP/def2-SVP nuclear forces on the card, against the JAX
    package's stored forces, their own mirror images and central
    differences of the energy on the card. The first gradient of the
    process: with the cyclic garbage collector off from the moment
    energy_grad returns, a weak reference to the calc must be dead once
    the phase drops it (calc_alive_after_grad). A cycle that holds the calc
    cannot be collected before then (the calc is still this frame's), and
    the collector stays on during the gradient, whose backward makes
    cycles of its own that hold device memory until it runs (with it off
    for the whole phase the gradient ran out of the card's memory)."""
    ref = np.load(FORCE_NPZ)
    torch.cuda.reset_peak_memory_stats()
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    calc = dq.KS(mol, xc="b3lyp", opts=dq.SCFOptions(tol=1e-11))
    calc.run()
    e = float(calc.energy())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    g = calc.energy_grad()
    gc.disable()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    F = -g["basis"]["atompos"].detach().cpu().numpy()
    Fref = ref["force"]
    Fref_sym = symmetric_part(Fref)
    dE = abs(e - float(ref["energy"]))
    dF = float(np.abs(F - Fref_sym).max())
    mirror = max(float(np.abs(F - mirror_forces(F, ax)).max())
                 for ax in (0, 1))
    sumF = float(np.abs(F.sum(0)).max())
    grid_dist, grid_wgap = grid_mirror_gaps(calc._theta["grid"])
    rec = {"system": "benzene", "basis": "def2-svp", "method": "RKS-B3LYP",
           "grid": 2, "tol": 1e-11, "energy_ha": e,
           "energy_anchor_ha": float(ref["energy"]), "abs_dE_ha": dE,
           "max_abs_dF_vs_symmetric_stored": dF,
           "max_abs_dF_vs_stored_raw": float(np.abs(F - Fref).max()),
           "max_abs_mirror_gap": mirror,
           "stored_forces_max_abs_mirror_gap": max(
               float(np.abs(Fref - mirror_forces(Fref, ax)).max())
               for ax in (0, 1)),
           "grid_mirror_max_point_gap_bohr": grid_dist,
           "grid_mirror_max_rel_weight_gap": grid_wgap,
           "max_abs_sum_F": sumF,
           "grad_s": calc.stats["grad_s"],
           "grad_forward_s": calc.stats["grad_forward_s"],
           "grad_backward_s": calc.stats["grad_backward_s"],
           "gmres": calc.stats["gmres"],
           "launches_in_gradient": launches,
           "peak_device_bytes_gradient": peak,
           "scf_iterations": calc.stats["iterations"],
           "residual": calc.stats["residual"],
           "forces": F.tolist(), "card": smi_line}
    # the second witness: central differences of energy_fn on the card
    central_differences("forces_fd", calc, F)
    alive = weakref.ref(calc)
    del calc, g
    rec["calc_alive_after_grad"] = alive() is not None
    gc.enable()
    emit({"forces": rec})
    if rec["calc_alive_after_grad"]:
        fail("the calc of energy_grad outlives the phase that dropped it")
    if not np.all(np.isfinite(F)) or F.shape != (12, 3):
        fail(f"forces not finite or of shape {F.shape}")
    if dE > FORCE_E_GATE:
        fail(f"energy {e!r} is {dE:.3e} Ha from the stored {FORCE_NPZ}")
    if grid_dist > GRID_SYM_GATE or grid_wgap > GRID_SYM_GATE:
        fail(f"the grid is not mirror symmetric ({grid_dist:.3e} Bohr, "
             f"{grid_wgap:.3e} in weight)")
    if mirror > MIRROR_GATE:
        fail(f"forces break the mirror symmetry by {mirror:.3e}")
    if dF > FORCE_GATE:
        fail(f"forces differ from the symmetric part of {FORCE_NPZ} by "
             f"{dF:.3e} > {FORCE_GATE}")
    if sumF > 1e-8:
        fail(f"sum of the forces {sumF:.3e} (translation invariance)")
    if not all(v > 0 for v in launches.values()):
        fail(f"kernels inside the gradient: {launches}")
    return rec


def central_differences(name, calc, F, components=FD_COMPONENTS):
    """Forces F of calc against central differences of energy_fn on the
    card at `components` ((atom, axis) pairs; h = FD_STEP), emitted under
    `name`; fails above FD_GATE."""
    p0 = calc._all_params()
    pos0 = p0["basis"]["atompos"]
    fd_rec = []
    t_fd = time.perf_counter()
    for atom, axis in components:
        es, res = [], []
        for sgn in (1, -1):
            pos = pos0.clone()
            pos[atom, axis] += sgn * FD_STEP
            with torch.no_grad():
                es.append(float(calc.energy_fn(
                    dict(p0, basis=dict(p0["basis"], atompos=pos)))))
            res.append(calc.stats["residual"])
        fd = -(es[0] - es[1]) / (2 * FD_STEP)
        fd_rec.append({"atom": atom, "axis": axis, "fd": fd,
                       "force": float(F[atom, axis]),
                       "abs_diff": abs(fd - float(F[atom, axis])),
                       "scf_residuals": res})
    emit({name: {"step_bohr": FD_STEP, "components": fd_rec,
                 "seconds": time.perf_counter() - t_fd}})
    for r in fd_rec:
        if not r["abs_diff"] <= FD_GATE:
            fail(f"{name}: force of atom {r['atom']} axis {r['axis']}: "
                 f"{r['force']!r} vs central difference {r['fd']!r}")


# the launches inside each call of sad_dm0 since reset_counts: the atomic
# SCFs of a SAD start, on the atoms' own small tensors
_SAD_LAUNCHES = []


def _all_counts():
    return dict(_launch_counts(),
                ds_jk_eri_lr=ds_jk.launches_by_tag.get("eri_lr", 0))


def _count_sad(sad_dm0):
    """qccalc.sad_dm0 that records the launches of its atomic SCFs, so that
    path_counts can leave them out."""
    def counted(mol, *args, **kwargs):
        before = _all_counts()
        dm = sad_dm0(mol, *args, **kwargs)
        after = _all_counts()
        _SAD_LAUNCHES.append({k: after[k] - before[k] for k in after})
        return dm
    return counted


def reset_counts():
    ds_jk.launches = ds_dens_gga.launches = ds_vxc_gga.launches = 0
    ds_jk.launches_by_tag.clear()
    _SAD_LAUNCHES.clear()


def sad_counts():
    """Launches of K1-K3 in the atomic SCFs of SAD starts since
    reset_counts."""
    return {k: sum(c[k] for c in _SAD_LAUNCHES) for k in _all_counts()}


def path_counts():
    """Launches of K1-K3 since reset_counts without those of the atomic SCFs
    of a SAD start (sad_counts): the molecule's own; and K1's on the erf
    tensors."""
    sad = sad_counts()
    return {k: v - sad[k] for k, v in _all_counts().items()}


def check_launches(name, eng, launches, per_it, builds, dense=True):
    """Gates on a restricted path's own launches. One steady iteration
    (per_it, measured by iteration_profile) launches K1 once, and once more
    per omega of the long-range exchange (none on the density-fitted,
    blocked and streamed routes: dense=False), and K2 and K3 once for a GGA
    or meta-GGA; the SCF launches that for each of its Fock builds, and one
    more K1 pass (on each tensor) and one more K2 for its energy."""
    xc = getattr(eng, "xc", None)
    n_lr = 0 if xc is None or not dense else len(xc.exx_lr)
    gga = int(xc is not None and xc.family >= 2)
    want_it = {"ds_jk": 1 + n_lr if dense else 0, "ds_dens_gga": gga,
               "ds_vxc_gga": gga, "ds_jk_eri_lr": n_lr}
    if per_it != want_it:
        fail(f"{name}: one iteration launched {per_it}, expected {want_it}")
    want = {k: builds * v + (0 if k == "ds_vxc_gga" else v)
            for k, v in per_it.items()}
    if launches != want:
        fail(f"{name}: the SCF launched {launches} for {builds} Fock builds "
             f"and its energy, expected {want}")


def plain_ks_energy(calc, dm):
    """The energy of a restricted KS calc at dm through the plain versions
    of all three kernels (J and K, each long-range K, rho and grad rho; the
    lapl and tau of a meta-GGA are plain torch on either path, and so are
    J and K on the density-fitted, blocked and streamed routes)."""
    eng, theta = calc.engine, calc._theta
    grid = theta["grid"]
    with torch.no_grad():
        if "eri_k" not in theta:
            j, k = eng.jk_parts(dm, theta)
            klr = eng.lr_parts(dm, theta)
        else:
            k, j = ds_jk_reference(theta["eri_k"], dm)
            klr = [ds_jk_reference(theta[f"eri_lr_k{i}"], dm)[0]
                   for i in range(len(eng.xc.exx_lr))]
        ao = grid["ao"]
        if eng.xc.family == 1:
            dens = {"rho": torch.einsum("gi,gi->g", ao @ dm, ao)}
        else:
            ag = grid["ao_grad"]
            rho, gdot = ds_dens_reference(ao, ag, dm)
            dens = {"rho": rho, "grad": gdot}
        if eng.xc.family >= 4:
            gg = torch.einsum("dgi,dgi->g", torch.einsum("dgi,ij->dgj", ag, dm),
                              ag)
            t1 = torch.einsum("gi,gi->g", grid["ao_lapl"] @ dm, ao)
            dens.update(lapl=2.0 * t1 + 2.0 * gg, tau=0.5 * gg)
        exc = torch.sum(integrate._edens_at(eng.xc, dens, False,
                                            theta.get("xc_params"))
                        * grid["dvol"])
        return float(eng.energy_from_parts(dm, j, k, theta, exc=exc,
                                           klr=klr))


def iteration_profile(eng, theta, dm, smi_line):
    """One DIIS iteration (density from a Fock matrix, Fock build, DIIS
    error) under torch.profiler: device time by kernel and the share of the
    iteration in which the card is idle; the kernels' launches in it."""
    with torch.no_grad():
        fock = eng.fock(dm, theta)

        def one_iteration():
            d = eng.dm_from_fock(fock, theta)
            eng.diis_err(eng.fock(d, theta), d, theta)
        one_iteration()
        torch.cuda.synchronize()
        reset_counts()
        one_iteration()
        launches = path_counts()
        torch.cuda.synchronize()
        t_it = time.perf_counter()
        for _ in range(3):
            one_iteration()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_it) / 3 * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                one_iteration()
            torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 3e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "wall_ms_per_iteration": wall_ms,
        "device_ms_per_iteration": dev_ms,
        "device_idle_share": (1.0 - dev_ms / wall_ms) if dev_ms > 0
        else None,
        "kernels_per_iteration": sum(e.count for e in dev_events) / 3,
        "port_kernel_launches_per_iteration": launches,
        "top_device_ms_per_iteration": [
            {"name": e.key[:80], "ms": e.self_device_time_total / 3e3,
             "launches": e.count / 3} for e in top],
        "card": smi_line}


def ks_phase(name, mol, xc, anchor, smi_line, nelec=NELEC, opts=None,
             gate=KS_GATE_HA):
    """One restricted KS path from Mol to the energy with the launch counts
    set to 0 just before it and read just after; the gates every KS path
    shares: the SCF converged, the energy within `gate` of its anchor
    (when it has one), the plain path within KS_PLAIN_GATE_HA, tr(D S) =
    nelec, the SAD start, the launches of one iteration and of the SCF
    (check_launches). A molecule with densityfit() takes the DF route, one
    past the dense limit the blocked one: theta holds no eri_k, and K1 is
    launched by the SAD atoms only. Returns (calc, record)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    calc = dq.KS(mol, xc=xc, opts=opts)
    reset_counts()
    calc.run()
    launches = path_counts()
    launches_sad = sad_counts()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = calc.stats
    theta = calc._theta
    dm = calc.aodm().contiguous()
    e = float(calc.energy())
    e_plain = plain_ks_energy(calc, dm)
    profile = iteration_profile(calc.engine, theta, dm, smi_line)
    trace_ds = float(torch.einsum("ij,ji->", dm, theta["ovlp"]))
    iters = st["iterations"]
    route = st["jk_mode"]
    rec = {"nao": mol.meta.nao, "ngrid": int(theta["grid"]["dvol"].shape[0]),
           "family": calc.engine.xc.family,
           "exx_fraction": calc.engine.xc.exx_fraction,
           "exx_lr": calc.engine.xc.exx_lr, "route": route,
           "guess": st.get("guess"), "sad_s": st.get("sad_s"),
           "sad_elements": st.get("sad_elements"),
           "int1e_s": st["int1e_s"], "eri_dense_s": st.get("eri_s"),
           "eri_lr_s": st.get("eri_lr_s"), "grid_s": st["grid_s"],
           "scf_s": st["scf_s"], "iterations": iters,
           "s_per_iteration": (st["scf_s"] - st.get("sad_s", 0.0))
           / max(iters, 1),
           "total_s": total_s, "residual": st["residual"],
           "tol": calc.opts.tol, "energy_ha": e, "energy_plain_ha": e_plain,
           "anchor_ha": anchor,
           "energy_minus_anchor_ha": None if anchor is None else e - anchor,
           "launches": launches, "launches_sad": launches_sad,
           "fock_builds": iters + 1, "iteration_profile": profile,
           "trace_dm_ovlp": trace_ds, "peak_device_bytes": peak,
           "device_bytes_at_start": at_start, "card": smi_line}
    if not np.isfinite(e) or tuple(dm.shape) != (mol.meta.nao,) * 2:
        fail(f"{name}: energy not finite or dm of the wrong shape")
    if not st["residual"] <= calc.opts.tol:
        fail(f"{name}: residual {st['residual']:.3e} above tol "
             f"{calc.opts.tol}")
    if route != calc.jk_mode:
        fail(f"{name}: theta of route {route!r}, the calc chose "
             f"{calc.jk_mode!r}")
    if route != "dense":
        rec.update({k: st[k] for k in DF_STATS + EXACT_STATS if k in st})
        if "eri_k" in theta or "eri_s" in st:
            fail(f"{name}: the {route} route built a dense ERI")
    if anchor is not None and abs(e - anchor) > gate:
        fail(f"{name}: energy {e!r} vs anchor {anchor!r} (gate {gate})")
    if abs(e - e_plain) > KS_PLAIN_GATE_HA:
        fail(f"{name}: kernel-path energy {e!r} vs plain-path {e_plain!r}")
    if abs(trace_ds - nelec) > 1e-8:
        fail(f"{name}: tr(D S) = {trace_ds!r}, expected {nelec}")
    if rec["guess"] != "sad":
        fail(f"{name}: the SCF started from {rec['guess']!r}, expected 'sad'")
    check_launches(name, calc.engine, launches,
                   profile["port_kernel_launches_per_iteration"],
                   rec["fock_builds"], dense=route == "dense")
    return calc, rec


def cam_b3lyp(smi_line):
    """CAM-B3LYP on benzene/def2-SVP: the long-range exchange of every Fock
    build is K1 on the erf-attenuated eri_lr_k0 (omega = 0.33)."""
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    calc, rec = ks_phase("cam_b3lyp", mol, "camb3lyp", CAM_ANCHOR_HA,
                         smi_line)
    theta = calc._theta
    dm = calc.aodm().contiguous()
    eng = calc.engine
    reset_counts()
    with torch.no_grad():
        eng.fock(dm, theta)
    rec["k1_launches_per_fock_build"] = dict(ds_jk.launches_by_tag)
    lr_check = check_kernel(theta["eri_lr_k0"], dm,
                            "benzene eri_lr_k0 (omega 0.33), converged dm")
    rec["eri_lr_kernel_check"] = lr_check
    emit({"cam_b3lyp": rec})
    if rec["k1_launches_per_fock_build"] != {"eri_k": 1, "eri_lr": 1}:
        fail("cam_b3lyp: K1 launches of one Fock build by tensor: "
             f"{rec['k1_launches_per_fock_build']}")
    return rec, lr_check


def meta_gga(smi_line):
    """SCAN on benzene/def2-SVP (K2 and K3 for rho, grad rho and their part
    of V; lapl and tau in plain torch), then SCAN exchange on CO and Li2
    against PySCF."""
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    calc, rec = ks_phase("meta_gga", mol, "scan", SCAN_ANCHOR_HA, smi_line)
    if "ao_lapl" not in calc._theta["grid"]:
        fail("meta_gga: the grid tables have no ao_lapl")
    del calc
    torch.cuda.empty_cache()
    pyscf = []
    for desc, grid, ref, tol in SCAN_PYSCF:
        t0 = time.perf_counter()
        qc = dq.KS(dq.Mol(desc, basis="6-311++G**", grid=grid),
                   xc="mgga_x_scan").run()
        e = float(qc.energy())
        pyscf.append({"system": desc, "basis": "6-311++G**", "grid": grid,
                      "xc": "mgga_x_scan", "energy_ha": e, "anchor_ha": ref,
                      "tol_ha": tol, "iterations": qc.stats["iterations"],
                      "seconds": time.perf_counter() - t0})
    rec["pyscf_anchors"] = pyscf
    emit({"meta_gga": rec})
    for r in pyscf:
        if not abs(r["energy_ha"] - r["anchor_ha"]) <= r["tol_ha"]:
            fail(f"meta_gga: {r['system']} SCAN exchange {r['energy_ha']!r} "
                 f"vs PySCF {r['anchor_ha']!r}")
    return rec


def nn_params_np():
    """Seeded NN parameters (tests/torch_anchor_report.nn_params_np)."""
    rng = np.random.default_rng(NN_SEED)
    return {"w1": 0.5 * rng.standard_normal(8),
            "ws": 0.5 * rng.standard_normal(8),
            "b1": 0.1 * rng.standard_normal(8),
            "w2": 0.5 * rng.standard_normal((8, 1)),
            "b2": 0.1 * rng.standard_normal(1)}


def nn_edens(p, d):
    """examples/04_neural_xc.py's functional with s = |grad rho|/rho^(4/3)
    as a second input, so that a GGA's kernels carry it."""
    rho, sigma = d["rho"], d["sigma"]
    n43 = rho ** (4.0 / 3.0)
    x = rho ** (1.0 / 3.0)
    s = torch.sqrt(torch.clamp(sigma, min=1e-40)) / n43
    h = torch.tanh(x[..., None] * p["w1"] + s[..., None] * p["ws"] + p["b1"])
    f = 1.0 + 0.2 * torch.tanh(h @ p["w2"] + p["b2"])[..., 0]
    c = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)
    return -c * n43 * f


def nn_xc(smi_line):
    """A family-2 CustomXC on benzene/def2-SVP: its energy, and
    energy_grad()['xc_params'] against central differences of the energy
    on the card along two seeded directions."""
    from dqc_tpu_torch.convert import xc_params_from_numpy
    from dqc_tpu_torch.xc.custom import CustomXC
    params = xc_params_from_numpy(nn_params_np(), device=DEV)
    xc = CustomXC(nn_edens, params, family=2, key="nnxc")
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    calc, rec = ks_phase("nn_xc", mol, xc, NN_ANCHOR_HA, smi_line,
                         opts=dq.SCFOptions(tol=1e-10))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    g = calc.energy_grad()["xc_params"]["nnxc"]
    launches = path_counts()
    rec.update(grad_s=calc.stats["grad_s"],
               grad_forward_s=calc.stats["grad_forward_s"],
               grad_backward_s=calc.stats["grad_backward_s"],
               gmres=calc.stats["gmres"], launches_in_gradient=launches,
               peak_device_bytes_gradient=torch.cuda.max_memory_allocated())
    p0 = calc._all_params()
    nn0 = p0["xc_params"]["nnxc"]
    rng = np.random.default_rng(NN_SEED + 1)
    fd = []
    t0 = time.perf_counter()
    for _ in range(2):
        v = {k: torch.as_tensor(rng.standard_normal(tuple(t.shape)),
                                device=DEV) for k, t in nn0.items()}
        slope = sum(float((g[k] * v[k]).sum()) for k in v)
        es = []
        for sgn in (1, -1):
            nn = {k: nn0[k] + sgn * NN_FD_STEP * v[k] for k in nn0}
            with torch.no_grad():
                es.append(float(calc.energy_fn(dict(p0,
                                                    xc_params={"nnxc": nn}))))
        cd = (es[0] - es[1]) / (2 * NN_FD_STEP)
        fd.append({"slope": slope, "central_difference": cd,
                   "rel_diff": abs(cd - slope) / abs(slope)})
    rec["param_grad_fd"] = {"step": NN_FD_STEP, "directions": fd,
                            "seconds": time.perf_counter() - t0,
                            "gate_rel": NN_FD_GATE_REL}
    rec["param_grad_norm"] = float(sum((t * t).sum() for t in g.values())
                                   ** 0.5)
    emit({"nn_xc": rec})
    if not all(v > 0 for k, v in launches.items() if k != "ds_jk_eri_lr"):
        fail(f"nn_xc: kernels inside the parameter gradient: {launches}")
    for r in fd:
        if not r["rel_diff"] <= NN_FD_GATE_REL:
            fail(f"nn_xc: parameter gradient {r['slope']!r} vs central "
                 f"difference {r['central_difference']!r}")
    return rec


# the batch axis (parallel/batch.py): 8 benzene geometries, Gaussian
# displacements of 0.02 Bohr from a numpy seed, the nn_xc functional
BATCH = 8
BATCH_SIGMA_BOHR = 0.02
BATCH_SEED = 14
BATCH_MEMBER_GATE_HA = 1e-10   # members against the unbatched energy_fn
BATCH_SIZES = (1, 3, 8)        # batched kernel checks
# the step of the loss's central differences: the loss's slope is small
# beside the energies' (targets near the energies), so the h^2 error of
# its central difference, mostly E's slope times its curvature, is 2e-5
# of it at h = 1e-4; at 1e-5 it is 100 times less, and the energies'
# rounding over 2h stays near 1e-9 of it
BATCH_FD_STEP = 1e-5
PURIFY_GATE = 1e-10            # purified dm against eigh's


def batched_kernel_checks(xc, theta_b, dm_b, smi_line):
    """K1, K2 and K3 with a leading batch axis at benzene's shapes on the
    batch's own tensors (eri_k and grid tables of BATCH geometries, their
    converged densities and potentials): at B = 1, 3, 8 against the plain
    version member by member (rel <= GATE_REL), one launch per call, two
    calls bit for bit, B = 1 bit for bit against the unbatched call; at B
    = 8 the kernel's time, the member loop of the plain version's, one
    batched PyTorch call's, and the bound."""
    grid = theta_b["grid"]
    ao, ag = grid["ao"], grid["ao_grad"]
    T = theta_b["eri_k"]
    with torch.no_grad():
        dens = integrate.density_from_tables(grid, dm_b, 2, False)
        _, vbar = integrate._pointwise_adjoints(
            xc, dens, grid["dvol"], False, theta_b["xc_params"])
    vr, vg = vbar["rho"].contiguous(), vbar["grad"].contiguous()

    def counted(fn):
        before = _launch_counts()
        out = fn()
        after = _launch_counts()
        return out, {k: after[k] - before[k] for k in after}

    recs = []
    for nb in BATCH_SIZES:
        args = {"ds_jk": (T[:nb], dm_b[:nb]),
                "ds_dens_gga": (ao[:nb], ag[:nb], dm_b[:nb]),
                "ds_vxc_gga": (ao[:nb], ag[:nb], vr[:nb], vg[:nb])}
        for name, kern, plain in (("ds_jk", ds_jk, ds_jk_reference),
                                  ("ds_dens_gga", ds_dens_gga,
                                   ds_dens_reference),
                                  ("ds_vxc_gga", ds_vxc_gga,
                                   ds_vxc_reference)):
            a = args[name]
            o1, n1 = counted(lambda: kern(*a))
            o2, _ = counted(lambda: kern(*a))
            ref = plain(*a)
            o1 = o1 if isinstance(o1, tuple) else (o1,)
            o2 = o2 if isinstance(o2, tuple) else (o2,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            rec = {"kernel": name, "batch": nb, "launches_per_call": n1,
                   "max_abs_err": 0.0, "max_rel_err": 0.0}
            for x, y, r in zip(o1, o2, ref):
                scale = r.abs().amax(dim=tuple(range(1, r.ndim)))
                err = (x - r).abs().amax(dim=tuple(range(1, r.ndim)))
                rel = float((err / scale).max())
                rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
                rec["max_rel_err"] = max(rec["max_rel_err"], rel)
                if not rel <= GATE_REL:
                    fail(f"batched {name} B={nb}: rel err {rel:.3e} per "
                         f"member > {GATE_REL}")
                if not torch.equal(x, y):
                    fail(f"batched {name} B={nb}: two calls differ")
            if n1[name] != 1 or sum(n1.values()) != 1:
                fail(f"batched {name} B={nb}: launches per call {n1}")
            if nb == 1:
                single = kern(*(t[0] for t in a))
                single = single if isinstance(single, tuple) else (single,)
                rec["bit_identical_to_unbatched"] = all(
                    torch.equal(x[0], y) for x, y in zip(o1, single))
                if not rec["bit_identical_to_unbatched"]:
                    fail(f"batched {name} B=1 differs from the unbatched "
                         "call")
            recs.append(rec)
    # times at B = 8, in turns; the plain version is the member loop
    nb = BATCH_SIZES[-1]
    n, (ng, nao) = T.shape[-1], tuple(ao.shape[-2:])
    dmc = dm_b[:nb]
    k1_ms, k1_plain = time_turns(lambda: ds_jk(T, dmc),
                                 lambda: ds_jk_reference(T, dmc), reps=10)
    k2_ms, k2_plain = time_turns(lambda: ds_dens_gga(ao, ag, dmc),
                                 lambda: ds_dens_reference(ao, ag, dmc))
    k3_ms, k3_plain = time_turns(lambda: ds_vxc_gga(ao, ag, vr, vg),
                                 lambda: ds_vxc_reference(ao, ag, vr, vg))

    def k1_library():
        torch.einsum("zijkl,zkl->zij", T, dmc)
        torch.einsum("ziabl,zal->zib", T, dmc)

    def k2_library():
        c = ao @ dmc.mT
        (c * ao).sum(-1)
        2.0 * (ag * c[:, None]).sum(-1)

    def k3_library():
        w = vr[..., None] * ao + 2.0 * torch.einsum("bdg,bdgi->bgi", vg, ag)
        w.mT @ ao
    libs = [time_ms(k1_library, 10), time_ms(k2_library, 20),
            time_ms(k3_library, 20)]
    k1_bytes = 8 * nb * (n ** 4 + 3 * n * n)
    xc_bytes = 8 * nb * (4 * ng * nao + nao * nao + 4 * ng)
    xc_flops = nb * (2 * ng * nao * nao + 8 * ng * nao)
    timing = {}
    for name, ms, pl, lib, b, f in (
            ("ds_jk", k1_ms, k1_plain, libs[0], k1_bytes, 4 * nb * n ** 4),
            ("ds_dens_gga", k2_ms, k2_plain, libs[1], xc_bytes, xc_flops),
            ("ds_vxc_gga", k3_ms, k3_plain, libs[2], xc_bytes, xc_flops)):
        bms, by = bound(b, f)
        timing[name] = {"batch": nb, "ms": min(ms), "ms_runs": ms,
                        "plain_ms": min(pl), "plain_ms_runs": pl,
                        "library_ms": lib, "bytes_moved": b, "flops": f,
                        "bound_ms": bms, "bound_by": by,
                        "bound_share": bms / min(ms),
                        "ms_per_member": min(ms) / nb, "card": smi_line}
    return recs, timing


def batch_loss(es, targets):
    return torch.mean((es - targets) ** 2)


def batch_nnxc(smi_line):
    """The batch axis at full width: BATCH benzene/def2-SVP geometries
    (seeded 0.02-Bohr displacements) with the nn_xc functional, tol 1e-10,
    through parallel/batch.energy_batch: the MSE loss against seeded
    targets and its gradient in xc_params only. Gates: members 0 and
    BATCH - 1 within BATCH_MEMBER_GATE_HA of the unbatched energy_fn at
    their geometries; the loss gradient against central differences
    along two seeded directions (NN_FD_GATE_REL); one launch each of K1,
    K2 and K3 per batched Fock build, and the SCF's launches as its Fock
    builds give them. Records the seconds of theta, the SCF and the backward,
    iterations per member, the peak, a steady batched iteration under the
    profiler, and the batched kernel checks."""
    from dqc_tpu_torch.convert import xc_params_from_numpy
    from dqc_tpu_torch.parallel import batch as pbatch
    from dqc_tpu_torch.utils.datastruct import batch_params, member_params
    from dqc_tpu_torch.xc.custom import CustomXC
    params = xc_params_from_numpy(nn_params_np(), device=DEV)
    xc = CustomXC(nn_edens, params, family=2, key="nnxc")
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    calc = dq.KS(mol, xc=xc, opts=dq.SCFOptions(tol=1e-10))
    rng = np.random.default_rng(BATCH_SEED)
    pos0 = mol.atompos.detach().cpu().numpy()
    pos_b = pos0 + BATCH_SIGMA_BOHR * rng.standard_normal(
        (BATCH,) + pos0.shape)
    targets = torch.as_tensor(NN_ANCHOR_HA + 0.05 * rng.standard_normal(
        BATCH), device=DEV)
    p0 = calc._all_params()
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p0["xc_params"]["nnxc"].items()}
    pb = batch_params(p0, pos_b)
    pb["xc_params"] = {"nnxc": leaves}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = {}
    reset_counts()
    t0 = time.perf_counter()
    with batch_captured() as got:
        es = pbatch.energy_batch(calc, pb, st)
    loss = batch_loss(es, targets)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = path_counts()
    launches_sad = sad_counts()
    peak_forward = torch.cuda.max_memory_allocated()
    reset_counts()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches_grad = path_counts()
    peak = torch.cuda.max_memory_allocated()
    g = dict(zip(leaves, grads))
    es_np = es.detach().cpu().numpy()
    iters = st["iterations"]
    builds = max(iters) + 1          # the start Fock and one per iteration
    rec = {"batch": BATCH, "system": "benzene", "basis": "def2-svp",
           "grid": 2, "nao": mol.meta.nao, "xc": "CustomXC family 2 (nn_xc)",
           "sigma_bohr": BATCH_SIGMA_BOHR, "seed": BATCH_SEED,
           "tol": calc.opts.tol, "energies_ha": es_np.tolist(),
           "loss": float(loss.detach()), "theta_s": st["theta_s"],
           "scf_s": st["scf_s"], "forward_s": t1 - t0,
           "backward_s": t2 - t1, "iterations": iters,
           "residuals": st["residual"], "fock_builds": builds,
           "launches": launches, "launches_sad": launches_sad,
           "launches_in_gradient": launches_grad,
           "gmres": st["gmres"], "peak_device_bytes_forward": peak_forward,
           "peak_device_bytes": peak, "card": smi_line}
    if not np.all(np.isfinite(es_np)) or es_np.shape != (BATCH,):
        fail(f"batch_nnxc: energies {es_np}")
    if not max(st["residual"]) <= calc.opts.tol:
        fail(f"batch_nnxc: residuals {st['residual']} above tol")
    del es, loss, grads

    # the stacked theta of the forward (no graph: only xc_params require
    # grad, and they stay outside theta's tensors) and its converged
    # states: the central differences, the profile of a steady batched
    # iteration and the batched kernel checks run on them
    theta_b, dm_b = got["theta"], got["dm"].contiguous()
    del got
    eng = calc.engine
    reset_counts()
    with torch.no_grad():
        eng.fock(dm_b, dict(theta_b, xc_params={"nnxc": params}))
    per_build = path_counts()
    rec["launches_per_fock_build"] = per_build
    want = {"ds_jk": 1, "ds_dens_gga": 1, "ds_vxc_gga": 1, "ds_jk_eri_lr": 0}
    if per_build != want:
        fail(f"batch_nnxc: one batched Fock build launched {per_build}")
    scf_want = {"ds_jk": builds + 1, "ds_dens_gga": builds + 1,
                "ds_vxc_gga": builds, "ds_jk_eri_lr": 0}
    if launches != scf_want:
        fail(f"batch_nnxc: the batched SCF and its energies launched "
             f"{launches} for {builds} Fock builds, expected {scf_want}")
    if not all(launches_grad[k] > 0 for k in ("ds_jk", "ds_dens_gga",
                                              "ds_vxc_gga")):
        fail(f"batch_nnxc: kernels in the gradient: {launches_grad}")
    theta_nn = dict(theta_b, xc_params={"nnxc": params})
    rec["iteration_profile"] = iteration_profile(eng, theta_nn, dm_b,
                                                 smi_line)

    # central differences of the loss along two seeded directions
    fd = []
    tf = time.perf_counter()
    rngd = np.random.default_rng(BATCH_SEED + 1)
    for _ in range(2):
        v = {k: torch.as_tensor(rngd.standard_normal(tuple(t.shape)),
                                device=DEV) for k, t in params.items()}
        slope = sum(float((g[k] * v[k]).sum()) for k in v)
        ls = []
        for sgn in (1, -1):
            th = dict(theta_b, xc_params={"nnxc": {
                k: params[k] + sgn * BATCH_FD_STEP * v[k] for k in params}})
            with torch.no_grad():
                d = pbatch.solve_batch(calc, th, dm_b)
                ls.append(float(batch_loss(eng.energy(d, th), targets)))
        cd = (ls[0] - ls[1]) / (2 * BATCH_FD_STEP)
        fd.append({"slope": slope, "central_difference": cd,
                   "rel_diff": abs(cd - slope) / abs(slope)})
    rec["loss_grad_fd"] = {"step": BATCH_FD_STEP, "directions": fd,
                           "seconds": time.perf_counter() - tf,
                           "gate_rel": NN_FD_GATE_REL}

    # the first and last members against the unbatched energy_fn at their
    # geometries
    members = {}
    for m in (0, BATCH - 1):
        tm = time.perf_counter()
        with torch.no_grad():
            em = float(calc.energy_fn(member_params(
                batch_params(p0, pos_b), m)))
        members[str(m)] = {"unbatched_ha": em, "batched_ha": float(es_np[m]),
                           "diff_ha": float(es_np[m]) - em,
                           "seconds": time.perf_counter() - tm}
    rec["members_vs_unbatched"] = members
    rec["member_gate_ha"] = BATCH_MEMBER_GATE_HA
    recs, timing = batched_kernel_checks(xc, theta_nn, dm_b, smi_line)
    rec["kernel_checks"] = recs
    rec["kernels"] = timing
    emit({"batch_nnxc": rec})
    for m, r in members.items():
        if not abs(r["diff_ha"]) <= BATCH_MEMBER_GATE_HA:
            fail(f"batch_nnxc: member {m} {r['batched_ha']!r} vs unbatched "
                 f"{r['unbatched_ha']!r}")
    for r in fd:
        if not r["rel_diff"] <= NN_FD_GATE_REL:
            fail(f"batch_nnxc: loss gradient {r['slope']!r} vs central "
                 f"difference {r['central_difference']!r}")
    return rec


def cache_benzene(smi_line):
    """B3LYP benzene/def2-SVP twice through Mol.set_cache on a temporary
    file: the first run builds theta and stores its parts, the second loads
    them (theta_cached, no eri_dense time, theta_s); the energies bit for
    bit; energy_grad after the cached run bit for bit against the uncached
    one (derivatives rebuild theta from the params)."""
    import tempfile
    rec = {"card": smi_line}
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "benzene_theta.npz")
        calcs = []
        for run in ("build", "load"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
            calc = dq.KS(mol.set_cache(fname), xc="b3lyp").run()
            st = calc.stats
            rec[run] = {"theta_s": st["theta_s"], "scf_s": st["scf_s"],
                        "eri_dense_s": st.get("eri_s"),
                        "grid_s": st.get("grid_s"),
                        "theta_cached": st["theta_cached"],
                        "iterations": st["iterations"],
                        "energy_ha": float(calc.energy()),
                        "total_s": time.perf_counter() - t0}
            calcs.append(calc)
        rec["file_bytes"] = os.path.getsize(fname)
        rec["signature"] = mol.cache_signature
    e_equal = bool(torch.equal(calcs[0].energy(), calcs[1].energy()))
    grads = []
    for calc in calcs:
        grads.append(calc.energy_grad()["basis"]["atompos"])
        calc._theta = None
    g_equal = bool(torch.equal(grads[0], grads[1]))
    rec.update(energy_bit_identical=e_equal, grad_bit_identical=g_equal,
               grad_max_abs_diff=float((grads[0] - grads[1]).abs().max()),
               grad_s=calcs[1].stats["grad_s"])
    emit({"cache_benzene": rec})
    if rec["build"]["theta_cached"] != [] or \
            rec["load"]["theta_cached"] != ["core", "grid"]:
        fail(f"cache_benzene: parts loaded {rec['build']['theta_cached']} "
             f"then {rec['load']['theta_cached']}")
    if rec["load"]["eri_dense_s"] is not None:
        fail("cache_benzene: the cached run built eri_dense")
    if not e_equal:
        fail("cache_benzene: the cached energy differs from the built one")
    if not g_equal:
        fail("cache_benzene: energy_grad after the cached run differs from "
             "the uncached one")
    return rec


def purify_benzene(calc, smi_line):
    """scf/purify.fock_to_dm_purify against eigh (engine.dm_from_fock) on
    benzene's converged B3LYP Fock matrix: the density matrices within
    PURIFY_GATE, and both times."""
    from dqc_tpu_torch.scf.purify import PURIFY_ITERS, fock_to_dm_purify
    theta, eng = calc._theta, calc.engine
    dm = calc.aodm().contiguous()
    with torch.no_grad():
        fock = eng.fock(dm, theta)
        dm_e = eng.dm_from_fock(fock, theta)
        dm_p = fock_to_dm_purify(fock, theta["X"], theta["keep"],
                                 theta["occ"])
        eigh_ms = time_ms(lambda: eng.dm_from_fock(fock, theta), 10)
        pur_ms = time_ms(lambda: fock_to_dm_purify(
            fock, theta["X"], theta["keep"], theta["occ"]), 10)
    err = float((dm_p - dm_e).abs().max())
    rec = {"nao": dm.shape[0], "iters": PURIFY_ITERS, "max_abs_diff": err,
           "gate": PURIFY_GATE, "eigh_ms": eigh_ms, "purify_ms": pur_ms,
           "trace_dm_ovlp": float(torch.einsum("ij,ji->", dm_p,
                                               theta["ovlp"])),
           "card": smi_line}
    emit({"purify_benzene": rec})
    if not err <= PURIFY_GATE:
        fail(f"purify_benzene: purified dm {err:.3e} from eigh's")
    return rec


def vitamin_c(smi_line):
    """B3LYP on vitamin C/def2-SVP (nao = 208): the dense route past nao
    128 (K1's streamed-dm plan, K2/K3 with two panels) on a real SCF.
    cc-pVDZ gives the same nao, but its general contractions (the s
    shells of C and O share their primitives) made the ERI build nine
    tenths of the phase's time, and the blocked route's block build as
    much again."""
    mol = dq.Mol(VITAMIN_C, basis=VITC_BASIS, grid=2)
    retries = alloc_retries()
    _AUTO_BLOCKS.clear()
    calc, rec = ks_phase("vitamin_c", mol, "b3lyp", None, smi_line,
                         nelec=VITAMIN_C_NELEC)
    rec.update(alloc_retries=alloc_retries() - retries,
               auto_blocks=auto_blocks())
    n = mol.meta.nao
    rec["eri_bytes"] = 8 * n ** 4
    rec["peak_over_eri"] = rec["peak_device_bytes"] / rec["eri_bytes"]
    # the three kernels at this path's shapes against their plain versions,
    # and K1's time there (dm's rows streamed with T's above n = 128)
    theta, grid = calc._theta, calc._theta["grid"]
    dm = calc.aodm().contiguous()
    eri_k, ao, ag = theta["eri_k"], grid["ao"], grid["ao_grad"]
    rho, gdot = ds_dens_reference(ao, ag, dm)
    _, vbar = integrate._pointwise_adjoints(
        calc.engine.xc, {"rho": rho, "grad": gdot}, grid["dvol"], False,
        None)
    vr, vg = vbar["rho"].contiguous(), vbar["grad"].contiguous()
    rec["kernel_checks"] = [
        check_kernel(eri_k, dm, f"vitamin C eri_k ({n}), converged dm"),
        check_dens(ao, ag, dm, "vitamin C grid, converged dm"),
        check_vxc(ao, ag, vr, vg, "vitamin C grid, real vrho/vgrad")]
    k1_ms, k1_plain = time_turns(lambda: ds_jk(eri_k, dm),
                                 lambda: ds_jk_reference(eri_k, dm), reps=5)
    k1_bound, k1_by = bound(8 * (n ** 4 + 3 * n ** 2), 4 * n ** 4)
    rec["ds_jk_at_n"] = {"n": n, "ms_runs": k1_ms, "plain_ms_runs": k1_plain,
                         "bound_ms": k1_bound, "bound_by": k1_by,
                         "plan": hopper_jk.jk_plan(
                             n, torch.cuda.get_device_properties(0)
                             .multi_processor_count)}
    emit({"vitamin_c": rec})
    if n <= 128:
        fail(f"vitamin_c: nao = {n}, expected above 128")
    return rec


def route_parts(calc, smi_line, reps=5):
    """Device time of each part of one steady iteration of the DF or the
    blocked route at the converged dm: RI-J, RI-K (when the functional has
    exact exchange) and RI-K on each long-range fit, or the block
    contraction (J, and K when the functional has exact exchange, in one
    pass: jk_blocks); K2 and K3 (GGA), and eigh of the orthogonalised Fock
    matrix; per call, under torch.profiler (device_ms: the kernels launched
    in the part's labelled range) and by CUDA events (event_ms)."""
    eng, theta = calc.engine, calc._theta
    dm = calc.aodm().contiguous()
    grid = theta["grid"]
    want_k = eng.xc.exx_fraction != 0.0
    if "df" in theta:
        parts = {"ri_j": lambda: df_j(theta["df"], dm)}
        if want_k:
            parts["ri_k"] = lambda: df_k(theta["df"], dm)
        for i in range(len(eng.xc.exx_lr)):
            parts[f"ri_k_lr{i}"] = lambda i=i: df_k(theta[f"df_lr{i}"], dm)
    else:
        parts = {"jk_blocks": lambda: eng._exact_jk(theta, dm, True, want_k)}
    if eng.xc.family >= 2:
        ao, ag = grid["ao"], grid["ao_grad"]
        rho, gdot = ds_dens_reference(ao, ag, dm)
        _, vbar = integrate._pointwise_adjoints(
            eng.xc, {"rho": rho, "grad": gdot}, grid["dvol"], False, None)
        vr, vg = vbar["rho"].contiguous(), vbar["grad"].contiguous()
        parts["ds_dens_gga"] = lambda: ds_dens_gga(ao, ag, dm)
        parts["ds_vxc_gga"] = lambda: ds_vxc_gga(ao, ag, vr, vg)
    with torch.no_grad():
        X = theta["X"]
        f = eng.fock(dm, theta)
        fo = X.T @ f @ X
        fo = 0.5 * (fo + fo.T)
    parts["eigh"] = lambda: torch.linalg.eigh(fo)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    with torch.no_grad():
        for fn in parts.values():
            fn()
        torch.cuda.synchronize()
        # one profiler session, each part in its own labelled range; the
        # range's device time is that of the kernels launched inside it
        with torch.profiler.profile(activities=acts) as prof:
            for name, fn in parts.items():
                with torch.profiler.record_function(f"part:{name}"):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
        events = prof.key_averages()
        for name, fn in parts.items():
            evs = [e for e in events if e.key == f"part:{name}"]
            # the host-side range sums its kernels' device time; without
            # it, the device-side annotation's span
            host = [e.device_time_total for e in evs
                    if e.device_type == torch.autograd.DeviceType.CPU]
            span = [e.self_device_time_total for e in evs
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            us = (host[0] if host and host[0] > 0 else
                  span[0] if span else None)
            out[name] = {"device_ms": None if us is None
                         else us / reps / 1e3,
                         "event_ms": time_ms(fn, reps)}
    if "df" in theta:
        b = theta["df"]["B"]
        out["B_bytes"] = b.numel() * 8
        out["B_shape"] = list(b.shape)
    out["card"] = smi_line
    return out


def df_b3lyp(smi_line):
    """B3LYP on benzene/def2-SVP after densityfit(): RI-J and RI-K each Fock
    build, K2 and K3 on the grid, no dense ERI and no K1 outside SAD."""
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2).densityfit()
    calc, rec = ks_phase("df_b3lyp", mol, "b3lyp", DF_ANCHOR_HA, smi_line)
    rec["dense_anchor_ha"] = KS_ANCHOR_HA
    rec["df_minus_dense_anchor_ha"] = rec["energy_ha"] - KS_ANCHOR_HA
    rec["own_fit_anchor_ha"] = DF_ANCHOR_OWN_FIT_HA
    rec["energy_minus_own_fit_anchor_ha"] = (rec["energy_ha"]
                                             - DF_ANCHOR_OWN_FIT_HA)
    rec["theta_zz"] = quadrupole_zz(calc)
    rec["parts"] = route_parts(calc, smi_line)
    emit({"df_b3lyp": rec})
    return rec


def df_cam_b3lyp(smi_line):
    """CAM-B3LYP on the DF route: the long-range K of each Fock build is
    RI-K on one attenuated-metric fit, df_lr0 (omega = 0.33)."""
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2).densityfit()
    calc, rec = ks_phase("df_cam_b3lyp", mol, "camb3lyp", DF_CAM_ANCHOR_HA,
                         smi_line)
    rec["own_fit_anchor_ha"] = DF_CAM_ANCHOR_OWN_FIT_HA
    rec["energy_minus_own_fit_anchor_ha"] = (rec["energy_ha"]
                                             - DF_CAM_ANCHOR_OWN_FIT_HA)
    lr = [k for k in calc._theta if k.startswith("df_lr")]
    rec["lr_fits"] = lr
    rec["parts"] = route_parts(calc, smi_line)
    emit({"df_cam_b3lyp": rec})
    if lr != ["df_lr0"] or [r["omega"] for r in rec["df_lr"]] != [0.33]:
        fail(f"df_cam_b3lyp: long-range fits {lr}, {rec['df_lr']}")
    return rec


def df_forces(smi_line):
    """Forces of benzene B3LYP on the DF route by implicit differentiation
    (tol 1e-11): their mirror symmetry, sum, central differences on the
    card, and their gap to the stored dense forces' mirror-symmetric part
    (the autoaux fitting error)."""
    ref = np.load(FORCE_NPZ)
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2).densityfit()
    calc = dq.KS(mol, xc="b3lyp", opts=dq.SCFOptions(tol=1e-11))
    calc.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    g = calc.energy_grad()
    launches = path_counts()
    peak = torch.cuda.max_memory_allocated()
    F = -g["basis"]["atompos"].detach().cpu().numpy()
    mirror = max(float(np.abs(F - mirror_forces(F, ax)).max())
                 for ax in (0, 1))
    sumF = float(np.abs(F.sum(0)).max())
    rec = {"system": "benzene", "basis": "def2-svp", "method": "RKS-B3LYP",
           "route": "df", "grid": 2, "tol": 1e-11,
           "energy_ha": float(calc.energy()),
           "max_abs_dF_vs_dense_symmetric_stored":
               float(np.abs(F - symmetric_part(ref["force"])).max()),
           "max_abs_mirror_gap": mirror, "max_abs_sum_F": sumF,
           "grad_s": calc.stats["grad_s"],
           "grad_forward_s": calc.stats["grad_forward_s"],
           "grad_backward_s": calc.stats["grad_backward_s"],
           "gmres": calc.stats["gmres"], "launches_in_gradient": launches,
           "peak_device_bytes_gradient": peak,
           "scf_iterations": calc.stats["iterations"],
           "residual": calc.stats["residual"], "forces": F.tolist(),
           "card": smi_line}
    emit({"df_forces": rec})
    if not np.all(np.isfinite(F)) or F.shape != (12, 3):
        fail(f"df_forces: forces not finite or of shape {F.shape}")
    if mirror > MIRROR_GATE:
        fail(f"df_forces: the forces break the mirror symmetry by "
             f"{mirror:.3e}")
    if sumF > 1e-8:
        fail(f"df_forces: sum of the forces {sumF:.3e}")
    if launches["ds_jk"] != 0 or not (launches["ds_dens_gga"] > 0
                                      and launches["ds_vxc_gga"] > 0):
        fail(f"df_forces: kernels inside the gradient: {launches}")
    central_differences("df_forces_fd", calc, F)
    return rec


def df_vitamin_c(smi_line, dense):
    """The reference's benchmark workload as benchmarks/vitamin_c.py runs it
    by default: vitamin C/cc-pVDZ, grid 2, densityfit(), lda_x+lda_c_pw;
    df_s and the peak beside the dense vitamin_c phase's in this run (in
    VITC_BASIS, at the same nao)."""
    mol = dq.Mol(VITAMIN_C, basis="cc-pvdz", grid=2).densityfit()
    calc, rec = ks_phase("df_vitamin_c", mol, "lda_x+lda_c_pw",
                         VITC_DF_ANCHOR_HA, smi_line,
                         nelec=VITAMIN_C_NELEC, gate=VITC_DF_GATE_HA)
    rec.update(harness_ha=VITC_DF_HARNESS_HA,
               energy_minus_harness_ha=rec["energy_ha"] - VITC_DF_HARNESS_HA,
               dense_phase_eri_dense_s=dense["eri_dense_s"],
               dense_phase_peak_device_bytes=dense["peak_device_bytes"],
               dense_phase_xc="b3lyp", dense_phase_basis=VITC_BASIS,
               gate_ha=VITC_DF_GATE_HA,
               parts=route_parts(calc, smi_line))
    emit({"df_vitamin_c": rec})
    return rec


def quadrupole_zz(calc):
    """Theta_zz = 1/2 int rho_total (3 z^2 - r^2) of a restricted calc's
    molecule about the origin (Buckingham), nuclei included."""
    mol = calc.mol
    dm = calc.aodm()
    with torch.no_grad():
        mp = lambda pw: integrals.multipole(mol.meta, mol.params, pw)
        q = 2.0 * mp((0, 0, 2)) - mp((2, 0, 0)) - mp((0, 2, 0))
        pos, z = mol.params["atompos"], mol.atomzs
        nuc = (z * (2 * pos[:, 2] ** 2 - pos[:, 0] ** 2 - pos[:, 1] ** 2)).sum()
        return 0.5 * float(nuc - (dm * q).sum())


def dimer_desc():
    """Two benzenes, the second DIMER_SHIFT_BOHR along z."""
    shifted = "; ".join(
        f"{a.split()[0]} {a.split()[1]} {a.split()[2]} {DIMER_SHIFT_BOHR}"
        for a in benzene_desc().split("; "))
    return benzene_desc() + "; " + shifted


def dimer_kernel_checks(calc):
    """K2 and K3 at the dimer's shape (nao 228, two panels) against their
    plain versions, at the converged dm and the real vrho, vgrad."""
    grid = calc._theta["grid"]
    dm = calc.aodm().contiguous()
    ao, ag = grid["ao"], grid["ao_grad"]
    rho, gdot = ds_dens_reference(ao, ag, dm)
    _, vbar = integrate._pointwise_adjoints(
        calc.engine.xc, {"rho": rho, "grad": gdot}, grid["dvol"], False, None)
    vr, vg = vbar["rho"].contiguous(), vbar["grad"].contiguous()
    return [check_dens(ao, ag, dm, "dimer grid (nao 228), converged dm"),
            check_vxc(ao, ag, vr, vg, "dimer grid, real vrho/vgrad")]


def df_beyond_dense(smi_line, e_df_benzene, theta_zz):
    """Two benzenes DIMER_SHIFT_BOHR apart (nao 228): the 21.6 GB ERI does
    not fit the dense route; the DF route gives twice the df_b3lyp energy
    plus the two quadrupoles' interaction, with K2 and K3 at nao 228
    against their plain versions."""
    mol = dq.Mol(dimer_desc(), basis="def2-svp", grid=2)
    nao = mol.meta.nao
    # without densityfit() the calc takes a route past the dense one
    route = dq.KS(mol, xc="b3lyp").jk_mode
    if route == "dense":
        fail("df_beyond_dense: the dense route took the dimer")
    mol.densityfit()
    e_qq = 6.0 * theta_zz ** 2 / DIMER_SHIFT_BOHR ** 5
    calc, rec = ks_phase("df_beyond_dense", mol, "b3lyp",
                         2 * e_df_benzene + e_qq, smi_line, nelec=2 * NELEC,
                         gate=DIMER_GATE_HA)
    checks = dimer_kernel_checks(calc)
    grid = calc._theta["grid"]
    ao = grid["ao"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rec.update(route_without_densityfit=route, dense_eri_bytes=8 * nao ** 4,
               dense_limit_bytes=qccalc.config.DENSE_ERI_BYTES_LIMIT,
               shift_bohr=DIMER_SHIFT_BOHR,
               energy_minus_twice_df_b3lyp_ha=rec["energy_ha"]
               - 2 * e_df_benzene, theta_zz=theta_zz,
               quadrupole_energy_ha=e_qq,
               kernel_checks=checks,
               ds_dens_gga_plan=hopper_xc.dens_plan(ao.shape[0], nao, sms),
               ds_vxc_gga_plan=hopper_xc.vxc_plan(ao.shape[0], nao, sms),
               parts=route_parts(calc, smi_line))
    emit({"df_beyond_dense": rec})
    if nao != 228 or rec["ngrid"] != 156288:
        fail(f"df_beyond_dense: nao {nao}, ng {rec['ngrid']}; expected 228 "
             "and 156288")
    if 8 * nao ** 4 <= qccalc.config.DENSE_ERI_BYTES_LIMIT:
        fail("df_beyond_dense: the dimer's ERI fits the dense limit")
    return rec, checks


def df_uks_o2(smi_line):
    """O2 triplet, UKS-LDA on the DF route, against PySCF; the polarized
    RI-K gives one K per spin (the LDA's own Fock builds compute none)."""
    desc, basis, grid, ref, tol = O2_DF_PYSCF
    mol = dq.Mol(desc, basis=basis, grid=grid, spin=2).densityfit()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()
    calc = dq.KS(mol, xc="lda_x+lda_c_pw", restricted=False).run()
    launches = path_counts()
    e = float(calc.energy())
    theta = calc._theta
    d = calc.aodm()
    dm = torch.stack([d.u, d.d])
    with torch.no_grad():
        k = df_k(theta["df"], dm)
        k_each = [df_k(theta["df"], dm[s]) for s in (0, 1)]
        _, k_fock = calc.engine.jk_parts(dm, theta)
    nel = [float(torch.einsum("ij,ji->", dm[s], theta["ovlp"]))
           for s in (0, 1)]
    rec = {"system": "O2", "basis": basis, "grid": grid, "spin": 2,
           "xc": "lda_x+lda_c_pw", "nao": mol.meta.nao,
           "naux": calc.stats["naux"], "energy_ha": e, "anchor_ha": ref,
           "tol_ha": tol, "energy_minus_anchor_ha": e - ref,
           "iterations": calc.stats["iterations"],
           "residual": calc.stats["residual"], "trace_dm_ovlp_by_spin": nel,
           "ri_k_shape": list(k.shape), "launches": launches,
           "launches_sad": sad_counts(),
           "total_s": time.perf_counter() - t0,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "card": smi_line}
    emit({"df_uks_o2": rec})
    if not calc.stats["residual"] <= calc.opts.tol:
        fail(f"df_uks_o2: residual {calc.stats['residual']:.3e}")
    if not abs(e - ref) <= tol:
        fail(f"df_uks_o2: energy {e!r} vs PySCF {ref!r}")
    if tuple(k.shape) != (2,) + tuple(dm.shape[1:]) or not all(
            torch.equal(k[s], k_each[s]) for s in (0, 1)):
        fail("df_uks_o2: the polarized RI-K is not one K per spin")
    if k_fock is not None:
        fail("df_uks_o2: the LDA's Fock build computed RI-K")
    if abs(nel[0] - 9.0) > 1e-8 or abs(nel[1] - 7.0) > 1e-8:
        fail(f"df_uks_o2: tr(D S) by spin {nel}, expected 9 and 7")
    if any(launches.values()):
        fail(f"df_uks_o2: kernels launched on an LDA DF path: {launches}")
    return rec


def blocked_b3lyp(smi_line, dense, eri_k):
    """Benzene B3LYP/def2-SVP on the blocked route (the dense limit set to
    0): the canonical quartet blocks cached in theta and contracted on every
    Fock build. Against the dense main_path_ks of this run: the energy, and
    J and K at the converged dm against K1's on its eri_k; the same blocks
    and dm contracted twice give the same bits."""
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    with route_limits(dense=0):
        calc, rec = ks_phase("blocked_b3lyp", mol, "b3lyp", KS_ANCHOR_HA,
                             smi_line)
    theta, eng = calc._theta, calc.engine
    dm = calc.aodm().contiguous()
    with torch.no_grad():
        j1, k1 = eng.jk_parts(dm, theta)
        j2, k2 = eng.jk_parts(dm, theta)
        jd, kd = ds_jk_kplanes(eri_k, dm)
    rel = {name: float((a - r).abs().max() / r.abs().max())
           for name, a, r in (("j", j1, jd), ("k", k1, kd))}
    repeats = bool(torch.equal(j1, j2) and torch.equal(k1, k2))
    e = rec["energy_ha"]
    rec.update(energy_dense_ha=dense["energy_ha"],
               energy_minus_dense_ha=e - dense["energy_ha"],
               j_rel_err_vs_k1=rel["j"], k_rel_err_vs_k1=rel["k"],
               bit_identical_repeat=repeats,
               parts=route_parts(calc, smi_line))
    emit({"blocked_b3lyp": rec})
    if rec["route"] != "blocked":
        fail(f"blocked_b3lyp: route {rec['route']!r}, expected 'blocked'")
    if abs(e - dense["energy_ha"]) > BLOCKED_E_GATE_HA:
        fail(f"blocked_b3lyp: energy {e!r} vs the dense route's "
             f"{dense['energy_ha']!r}")
    if not max(rel.values()) <= BLOCKED_JK_GATE_REL:
        fail(f"blocked_b3lyp: J, K against K1's: {rel}")
    if not repeats:
        fail("blocked_b3lyp: two contractions of the same blocks and dm "
             "differ")
    return rec


def blocked_forces(smi_line, dense):
    """energy_grad() of benzene B3LYP on the blocked route (tol 1e-11),
    against the dense forces phase of this run: the forces, their mirror
    gap and sum; no K1 inside the gradient."""
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    with route_limits(dense=0):
        calc = dq.KS(mol, xc="b3lyp", opts=dq.SCFOptions(tol=1e-11))
        calc.run()
    torch.cuda.synchronize()
    free_device()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    g = calc.energy_grad()
    launches = path_counts()
    peak = torch.cuda.max_memory_allocated()
    F = -g["basis"]["atompos"].detach().cpu().numpy()
    dF = float(np.abs(F - np.asarray(dense["forces"])).max())
    mirror = max(float(np.abs(F - mirror_forces(F, ax)).max())
                 for ax in (0, 1))
    sumF = float(np.abs(F.sum(0)).max())
    rec = {"system": "benzene", "basis": "def2-svp", "method": "RKS-B3LYP",
           "route": calc.jk_mode, "grid": 2, "tol": 1e-11,
           "energy_ha": float(calc.energy()),
           "energy_minus_dense_forces_phase_ha":
               float(calc.energy()) - dense["energy_ha"],
           "max_abs_dF_vs_dense": dF, "max_abs_mirror_gap": mirror,
           "max_abs_sum_F": sumF, "grad_s": calc.stats["grad_s"],
           "grad_forward_s": calc.stats["grad_forward_s"],
           "grad_backward_s": calc.stats["grad_backward_s"],
           "gmres": calc.stats["gmres"], "launches_in_gradient": launches,
           "peak_device_bytes_gradient": peak,
           "dense_peak_device_bytes_gradient":
               dense["peak_device_bytes_gradient"],
           "scf_iterations": calc.stats["iterations"],
           "residual": calc.stats["residual"], "forces": F.tolist(),
           "card": smi_line}
    emit({"blocked_forces": rec})
    if calc.jk_mode != "blocked":
        fail(f"blocked_forces: route {calc.jk_mode!r}, expected 'blocked'")
    if not np.all(np.isfinite(F)) or F.shape != (12, 3):
        fail(f"blocked_forces: forces not finite or of shape {F.shape}")
    if not dF <= BLOCKED_FORCE_GATE:
        fail(f"blocked_forces: {dF:.3e} from the dense forces")
    if not mirror <= BLOCKED_MIRROR_GATE:
        fail(f"blocked_forces: mirror gap {mirror:.3e}")
    if not sumF <= 1e-8:
        fail(f"blocked_forces: sum of the forces {sumF:.3e}")
    if launches["ds_jk"] != 0 or not (launches["ds_dens_gga"] > 0
                                      and launches["ds_vxc_gga"] > 0):
        fail(f"blocked_forces: kernels inside the gradient: {launches}")
    return rec


def stream_b3lyp(smi_line, dense):
    """Benzene B3LYP on the streamed route (both limits set to 0): every
    exact Fock build rebuilds the blocks; the SCF iterates on the autoaux
    RI fit, then polishes with exact J/K (qccalc._stream_solve), and stops
    at tol or on stagnation. Gates: the energy against main_path_ks's, K1
    only in the SAD atoms, K2 and K3 once per Fock build (and K2 once more
    for the energy), tr(D S)."""
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    torch.cuda.synchronize()
    free_device()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with route_limits(dense=0, blocked=0):
        calc = dq.KS(mol, xc="b3lyp")
        reset_counts()
        calc.run()
    launches = path_counts()
    torch.cuda.synchronize()
    st = calc.stats
    e = float(calc.energy())
    dm = calc.aodm()
    trace_ds = float(torch.einsum("ij,ji->", dm, calc._theta["ovlp"]))
    builds = st["iterations"] + 1
    want = {"ds_jk": 0, "ds_dens_gga": builds + 1, "ds_vxc_gga": builds,
            "ds_jk_eri_lr": 0}
    rec = {"nao": mol.meta.nao, "route": st["jk_mode"], "guess": st["guess"],
           "energy_ha": e, "energy_dense_ha": dense["energy_ha"],
           "energy_minus_dense_ha": e - dense["energy_ha"],
           "anchor_ha": KS_ANCHOR_HA,
           "energy_minus_anchor_ha": e - KS_ANCHOR_HA,
           "residual": st["residual"], "tol": calc.opts.tol,
           "ri_iterations": st["ri_iterations"],
           "dual_inner_iterations": st["dual_inner_iterations"],
           "exact_jk": st["exact_jk"], "iterations": st["iterations"],
           "fock_builds": builds,
           **{k: st[k] for k in ("int1e_s", "grid_s", "sad_s", "scf_s",
                                 "energy_s") + EXACT_STATS if k in st},
           "total_s": time.perf_counter() - t0, "launches": launches,
           "launches_sad": sad_counts(), "trace_dm_ovlp": trace_ds,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "card": smi_line}
    emit({"stream_b3lyp": rec})
    if rec["route"] != "stream" or calc.jk_mode != "stream":
        fail(f"stream_b3lyp: route {rec['route']!r}, expected 'stream'")
    if not abs(e - dense["energy_ha"]) <= STREAM_E_GATE_HA:
        fail(f"stream_b3lyp: energy {e!r} vs the dense route's "
             f"{dense['energy_ha']!r}")
    if launches != want:
        fail(f"stream_b3lyp: launched {launches} for {builds} Fock builds "
             f"and the energy, expected {want}")
    if abs(trace_ds - NELEC) > 1e-8:
        fail(f"stream_b3lyp: tr(D S) = {trace_ds!r}, expected {NELEC}")
    return rec


def blocked_vitamin_c(smi_line, dense):
    """Vitamin C/def2-SVP B3LYP on the blocked route (the dense limit set
    to 0), against the dense vitamin_c phase of this run: the energy, tr(D
    S); the block build's seconds beside eri_dense's, the peaks, the
    allocator's retries and the bra blocks coulomb_contract chose."""
    mol = dq.Mol(VITAMIN_C, basis=VITC_BASIS, grid=2)
    retries = alloc_retries()
    _AUTO_BLOCKS.clear()
    with route_limits(dense=0):
        calc, rec = ks_phase("blocked_vitamin_c", mol, "b3lyp", None,
                             smi_line, nelec=VITAMIN_C_NELEC)
    e = rec["energy_ha"]
    rec.update(alloc_retries=alloc_retries() - retries,
               auto_blocks=auto_blocks(),
               energy_dense_ha=dense["energy_ha"],
               energy_minus_dense_ha=e - dense["energy_ha"],
               dense_phase_eri_dense_s=dense["eri_dense_s"],
               dense_phase_peak_device_bytes=dense["peak_device_bytes"],
               dense_phase_alloc_retries=dense["alloc_retries"],
               dense_phase_auto_blocks=dense["auto_blocks"],
               peak_over_blocks=rec["peak_device_bytes"]
               / rec["jk_blocks_bytes"],
               parts=route_parts(calc, smi_line))
    emit({"blocked_vitamin_c": rec})
    if rec["route"] != "blocked":
        fail(f"blocked_vitamin_c: route {rec['route']!r}")
    if abs(e - dense["energy_ha"]) > BLOCKED_E_GATE_HA:
        fail(f"blocked_vitamin_c: energy {e!r} vs the dense route's "
             f"{dense['energy_ha']!r}")
    return rec


def blocked_beyond_dense(smi_line, e_benzene, theta_zz, e_df_dimer):
    """PR 9's benzene dimer without densityfit(): the dense route is not
    taken, the blocked one is. Its energy is twice main_path_ks's plus the
    quadrupoles' interaction (Theta_zz of the dense monomer's density);
    K2 and K3 at nao 228 against their plain versions."""
    mol = dq.Mol(dimer_desc(), basis="def2-svp", grid=2)
    e_qq = 6.0 * theta_zz ** 2 / DIMER_SHIFT_BOHR ** 5
    calc, rec = ks_phase("blocked_beyond_dense", mol, "b3lyp",
                         2 * e_benzene + e_qq, smi_line, nelec=2 * NELEC,
                         gate=DIMER_GATE_HA)
    checks = dimer_kernel_checks(calc)
    nao = mol.meta.nao
    rec.update(dense_eri_bytes=8 * nao ** 4,
               dense_limit_bytes=qccalc.config.DENSE_ERI_BYTES_LIMIT,
               blocked_limit_bytes=qccalc.config.BLOCKED_JK_BYTES_LIMIT,
               shift_bohr=DIMER_SHIFT_BOHR, theta_zz=theta_zz,
               quadrupole_energy_ha=e_qq,
               energy_minus_twice_dense_ha=rec["energy_ha"] - 2 * e_benzene,
               energy_minus_df_dimer_ha=rec["energy_ha"] - e_df_dimer,
               kernel_checks=checks, parts=route_parts(calc, smi_line))
    emit({"blocked_beyond_dense": rec})
    if rec["route"] != "blocked":
        fail(f"blocked_beyond_dense: route {rec['route']!r}, expected "
             "'blocked'")
    if nao != 228 or 8 * nao ** 4 <= qccalc.config.DENSE_ERI_BYTES_LIMIT:
        fail(f"blocked_beyond_dense: nao {nao}, or its ERI fits the dense "
             "limit")
    return rec, checks


# --- properties (api/properties.py): second and third derivatives -------

# H2O at the CCCBDB geometry of tests/test_properties.py:12 (Bohr)
H2O_CCCBDB = "O 0.0 0.0 0.2156; H 0.0 1.4749 -0.8625; H 0.0 -1.4749 -0.8625"
PROPS_TOL = 1e-11
# CCCBDB's HF/3-21G values, with the tolerances of tests/test_properties.py
CCCBDB_FREQS = ((3944.0, 3811.0, 1800.0), 1.5e-3)            # cm^-1, rtol
CCCBDB_IR = ((9.123, 0.047, 79.89), 1e-2)                     # km/mol, rtol
CCCBDB_RAMAN = ((44.12, 95.71, 11.5), 1e-3)                   # angst^4/amu
CCCBDB_DIPOLE_D = (2.39, 0.03)                                # |mu|, abs
CCCBDB_QUAD = ((-6.838, -3.972, -5.882), 2e-4, 1e-3)   # debye*angst diag
H2_BOND_BOHR = (1.3886, 2e-3)    # HF/3-21G H2 optimum (CCCBDB 0.7348 A)
# dqc_tpu HF/3-21G at H2O_CCCBDB, SCFOptions(mixed=False, tol=1e-11), one
# JAX-CPU run on an x86-64 host (about 20 minutes, most of it compiles):
#   JAX_PLATFORMS=cpu python tests/torch_anchor_report.py props_h2o_321g
# The port on the CPU gives the same values to 2e-11 relative (its CPU
# tests hold the STO-3G ones to 1e-9); the card is held to 1e-8 relative
# of each quantity's largest entry (the orbital Hessian's eigenvalue, 0 at
# a minimum up to rounding, to 1e-9 absolute).
JAX_H2O_321G = {
    "energy_ha": -75.58595972167704,
    "hessian_pos": [
        [0.000125292458, 0.0, 0.0, -6.2646229e-05, 0.0, 0.0,
         -6.2646229e-05, 0.0, 0.0],
        [0.0, 0.714854376056, 0.0, 0.0, -0.357427188028, 0.261220904818,
         0.0, -0.357427188028, -0.261220904818],
        [0.0, 0.0, 0.435349085382, 0.0, 0.182619304846, -0.217674542691,
         0.0, -0.182619304846, -0.217674542691],
        [-6.2646229e-05, 0.0, 0.0, 5.4016281e-05, 0.0, 0.0, 8.629948e-06,
         0.0, 0.0],
        [0.0, -0.357427188028, 0.182619304846, 0.0, 0.394903047354,
         -0.221920104832, 0.0, -0.037475859326, 0.039300799986],
        [0.0, 0.261220904818, -0.217674542691, 0.0, -0.221920104832,
         0.204331609195, 0.0, -0.039300799986, 0.013342933495],
        [-6.2646229e-05, 0.0, 0.0, 8.629948e-06, 0.0, 0.0, 5.4016281e-05,
         0.0, 0.0],
        [0.0, -0.357427188028, -0.182619304846, 0.0, -0.037475859326,
         -0.039300799986, 0.0, 0.394903047354, 0.221920104832],
        [0.0, -0.261220904818, -0.217674542691, 0.0, 0.039300799986,
         0.013342933496, 0.0, 0.221920104832, 0.204331609195]],
    "freqs_cm1": [3944.206909789844, 3810.890569042306, 1799.5079881717797],
    "ir_km_mol": [9.126543196358691, 0.04716721012258457, 79.8853665779199],
    "raman_angst4_amu": [44.109334891664034, 95.69863429581063,
                         11.499770995016638],
    "edipole_au": [0.0, 0.0, -0.9393500007677126],
    "equadrupole_au": [[-5.084067395974944, 0.0, 0.0],
                       [0.0, -2.953285499921961, 0.0],
                       [0.0, 0.0, -4.373143655026587]],
    # O[0,0,2], O[1,1,2], O[2,2,2]; the other entries are 0 or their
    # permutations
    "eoctupole_au": [-0.42592822669377006, -1.718296885526334,
                     -1.6690340597907816],
    "polarizability_au": [[0.7833401718708018, 0.0, 0.0],
                          [0.0, 6.803865398908144, 0.0],
                          [0.0, 0.0, 3.628527017009193]],
    "lowest_eival_orb_hessian": -1.645090240902957e-14,
}
PROPS_JAX_GATE_REL = 1e-8
VAR_GATE_HA = 1e-8         # the variational SCF against DIIS, same run
# central differences on the card: position step (Bohr) and field step
# (a.u.), and the gates (a.u.): truncation and the SCF's 1e-11 residual
# over 2h stay one to two orders below each
PROP_FD_POS = 1e-4
PROP_FD_FIELD = 1e-4
HESS_FD_GATE = 1e-6
ALPHA_FD_GATE = 1e-5
DALPHA_FD_GATE = 1e-5
# benzene: the dipole is 0 by symmetry; Theta_zz from equadrupole against
# quadrupole_zz's contraction; alpha's off-diagonal entries 0 by the mirror
# symmetries the grid keeps, and its diagonal against central differences
# of the dipole (two fields per axis). alpha_xx = alpha_yy needs the
# six-fold axis, which the grid breaks (each atom's Lebedev grid is fixed
# in the lab frame): B3LYP's alpha_xx - alpha_yy is held to the same
# difference of the central differences, and HF's (no grid) to 1e-8
BENZENE_DIPOLE_GATE = 1e-9
THETA_ZZ_GATE = 1e-8
BENZENE_ALPHA_SYM_GATE = 1e-8


def props_call(counts, key, fn):
    """fn() with the kernels' launches counted apart under `key` (counts
    set to 0 just before, read just after) beside its seconds."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts[key] = dict(path_counts(), seconds=time.perf_counter() - t0)
    return out


def _np(t):
    return t.detach().cpu().numpy()


def _rel_err(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def props_h2o_hf(smi_line):
    """All eleven property functions on HF H2O/3-21G on the card, against
    CCCBDB (tests/test_properties.py's tolerances) and the JAX package's
    values; H2's optimal geometry; the variational SCF with each orbital
    parametrisation against DIIS in the same run."""
    t_phase = time.perf_counter()
    mol = dq.Mol(H2O_CCCBDB, basis="3-21G")
    calc = dq.HF(mol, opts=dq.SCFOptions(tol=PROPS_TOL))
    calc.run()
    e = float(calc.energy())
    counts = {}
    hess = _np(props_call(counts, "hessian_pos",
                          lambda: P.hessian_pos(calc)))
    freqs, _ = props_call(counts, "vibration",
                          lambda: P.vibration(calc))
    _, ir = props_call(counts, "ir_spectrum",
                       lambda: P.ir_spectrum(calc))
    _, raman = props_call(counts, "raman_spectrum",
                          lambda: P.raman_spectrum(calc))
    mu = _np(props_call(counts, "edipole", lambda: P.edipole(calc)))
    mu_d = _np(P.edipole(calc, unit="debye"))
    quad = _np(props_call(counts, "equadrupole",
                          lambda: P.equadrupole(calc)))
    quad_da = _np(P.equadrupole(calc, unit="debye*angst"))
    octu = _np(props_call(counts, "eoctupole",
                          lambda: P.eoctupole(calc)))
    alpha = _np(props_call(counts, "polarizability",
                           lambda: P.polarizability(calc)))
    eig = float(props_call(counts, "lowest_eival_orb_hessian",
                           lambda: P.lowest_eival_orb_hessian(calc)))
    orb_min = props_call(counts, "is_orb_min",
                         lambda: P.is_orb_min(calc))
    freqs, ir, raman = _np(freqs), _np(ir), _np(raman)
    jax = JAX_H2O_321G
    errs = {
        "energy_ha": abs(e - jax["energy_ha"]),
        "hessian_pos": _rel_err(hess, jax["hessian_pos"]),
        "freqs_cm1": _rel_err(freqs[:3], jax["freqs_cm1"]),
        "ir_km_mol": _rel_err(ir[:3], jax["ir_km_mol"]),
        "raman_angst4_amu": _rel_err(raman[:3], jax["raman_angst4_amu"]),
        "edipole_au": _rel_err(mu, jax["edipole_au"]),
        "equadrupole_au": _rel_err(quad, jax["equadrupole_au"]),
        "eoctupole_au": _rel_err([octu[0, 0, 2], octu[1, 1, 2],
                                  octu[2, 2, 2]], jax["eoctupole_au"]),
        "polarizability_au": _rel_err(alpha, jax["polarizability_au"]),
        "lowest_eival_orb_hessian": abs(eig
                                        - jax["lowest_eival_orb_hessian"]),
    }
    octu_sym = max(float(np.abs(octu - octu.transpose(p)).max())
                   for p in ((1, 0, 2), (0, 2, 1), (2, 1, 0)))
    # H2's optimal geometry (tests/test_properties.py:60-68)
    qc_h2 = dq.HF(dq.Mol("H 0 0 0; H 1.3 0 0", basis="3-21G"),
                  opts=dq.SCFOptions(tol=PROPS_TOL))
    qc_h2.run()
    pos = _np(props_call(counts, "optimal_geometry",
                         lambda: P.optimal_geometry(qc_h2)))
    bond = float(np.linalg.norm(pos[1] - pos[0]))
    # the variational SCF, each parametrisation, from the same start
    var = {}
    for op in ("matexp", "qr", "ov"):
        qv = dq.HF(mol, opts=dq.SCFOptions(method="variational",
                                           orb_param=op))
        props_call(counts, f"variational_{op}", qv.run)
        st = qv.stats
        var[op] = {"energy_ha": float(qv.energy()),
                   "minus_diis_ha": float(qv.energy()) - e,
                   "bfgs_iterations": st["iterations"],
                   "evaluations": st["var_evaluations"],
                   "status": st["var_message"],
                   "grad_max_abs": st["var_grad_max_abs"],
                   "residual": st["residual"]}
    rec = {"system": "H2O (CCCBDB geometry)", "basis": "3-21G",
           "method": "RHF", "nao": mol.meta.nao, "energy_ha": e,
           "residual": calc.stats["residual"],
           "freqs_cm1": freqs.tolist(), "ir_km_mol": ir.tolist(),
           "raman_angst4_amu": raman.tolist(), "edipole_au": mu.tolist(),
           "edipole_debye": mu_d.tolist(),
           "equadrupole_debye_angst": quad_da.tolist(),
           "polarizability_au": alpha.tolist(),
           "lowest_eival_orb_hessian": eig, "is_orb_min": orb_min,
           "octupole_max_asymmetry": octu_sym,
           "jax_rel_err": errs, "jax_gate_rel": PROPS_JAX_GATE_REL,
           "h2_optimal_bond_bohr": bond,
           "h2_bfgs": qc_h2.stats["props"]["optimal_geometry"],
           "variational": var, "calls": counts,
           "records": {k: {kk: vv for kk, vv in v.items() if kk != "gmres"}
                       | {"gmres_solves": len(v.get("gmres", [])),
                          "gmres_max_rel": max([r["rel"] for r in
                                                v.get("gmres", [])],
                                               default=0.0)}
                       for k, v in calc.stats["props"].items()},
           "seconds": time.perf_counter() - t_phase, "card": smi_line}
    emit({"props_h2o_hf": rec})
    for name, (want, rtol) in (("freqs_cm1", CCCBDB_FREQS),
                               ("ir_km_mol", CCCBDB_IR),
                               ("raman_angst4_amu", CCCBDB_RAMAN)):
        got = np.asarray(rec[name][:3])
        if not np.all(np.abs(got - want) <= rtol * np.abs(want)):
            fail(f"props_h2o_hf: {name} {got.tolist()} vs CCCBDB {want} "
                 f"(rtol {rtol})")
    if abs(np.linalg.norm(mu_d) - CCCBDB_DIPOLE_D[0]) > CCCBDB_DIPOLE_D[1]:
        fail(f"props_h2o_hf: |mu| {np.linalg.norm(mu_d)} D vs CCCBDB")
    want_q, rtol_q, atol_q = CCCBDB_QUAD
    if not np.all(np.abs(quad_da - np.diag(want_q))
                  <= atol_q + rtol_q * np.abs(np.diag(want_q))):
        fail(f"props_h2o_hf: quadrupole {quad_da.tolist()} vs CCCBDB")
    for k, err in errs.items():
        gate = (1e-9 if k in ("energy_ha", "lowest_eival_orb_hessian")
                else PROPS_JAX_GATE_REL)
        if not err <= gate:
            fail(f"props_h2o_hf: {k} {err:.3e} from the JAX package's "
                 f"(gate {gate})")
    if octu_sym > 1e-12 or not orb_min:
        fail(f"props_h2o_hf: octupole asymmetry {octu_sym}, is_orb_min "
             f"{orb_min}")
    if abs(bond - H2_BOND_BOHR[0]) > H2_BOND_BOHR[1]:
        fail(f"props_h2o_hf: H2 optimal bond {bond} vs {H2_BOND_BOHR}")
    for op, v in var.items():
        if not abs(v["minus_diis_ha"]) <= VAR_GATE_HA:
            fail(f"props_h2o_hf: variational {op} {v['minus_diis_ha']:.3e} "
                 "Ha from DIIS")
    for key in ("hessian_pos", "ir_spectrum", "raman_spectrum",
                "polarizability", "lowest_eival_orb_hessian",
                "variational_ov"):
        if not counts[key]["ds_jk"] > 0:
            fail(f"props_h2o_hf: K1 not launched in {key}: {counts[key]}")
    return rec


def _dipole_at(calc, field):
    """-dE/dE_field + the nuclear dipole of a calc's molecule in a uniform
    field (energy_fn at those params, the field the only leaf)."""
    p = P._params(calc, "efield")
    p["efield"] = torch.as_tensor(field, dtype=torch.float64, device=DEV)
    with torch.enable_grad():
        pp, (f,) = calc._leaves(p, wrt=[("efield",)])
        (g,) = torch.autograd.grad(calc.energy_fn(pp), f)
    pos = p["basis"]["atompos"].detach()
    return _np(-g + torch.einsum("a,ad->d", p["atomzs"], pos))


# near the B3LYP/def2-SVP optimum of H2O (OH 1.819 Bohr, HOH 102.7
# degrees), distorted by a few hundredths of a Bohr
H2O_DISTORTED = "O 0.0 0.0 0.2; H 0.0 1.4509 -0.9363; H 0.0 -1.4209 -0.9163"


def props_h2o_b3lyp(smi_line):
    """B3LYP H2O/def2-SVP (grid 2) on the card through K1-K3:
    optimal_geometry from a distorted start; at the optimum the Hessian
    (and the frequencies: three real modes) against central differences
    of energy_grad, the polarizability against central differences of the
    dipole in a field, and Raman's dalpha/dR (a third derivative) against
    central differences of the polarizability."""
    t_phase = time.perf_counter()
    counts = {}
    qo = dq.KS(dq.Mol(H2O_DISTORTED, basis="def2-svp", grid=2),
               xc="b3lyp", opts=dq.SCFOptions(tol=PROPS_TOL))
    qo.run()
    pos_opt = props_call(counts, "optimal_geometry",
                         lambda: P.optimal_geometry(qo))
    mol = qo.mol.make_copy(atompos=pos_opt)
    calc = dq.KS(mol, xc="b3lyp", opts=dq.SCFOptions(tol=PROPS_TOL))
    calc.run()
    hess = _np(props_call(counts, "hessian_pos",
                          lambda: P.hessian_pos(calc)))
    freqs = _np(P.vibration(calc)[0])
    small = sorted(np.abs(freqs))[:6]
    p0 = calc._all_params()
    pos0 = p0["basis"]["atompos"].detach()
    hess_fd = []
    for atom, axis in ((0, 2), (1, 1)):
        gs = []
        for sgn in (1, -1):
            pos = pos0.clone()
            pos[atom, axis] += sgn * PROP_FD_POS
            gs.append(_np(calc.energy_grad(dict(p0, basis=dict(
                p0["basis"], atompos=pos)))["basis"]["atompos"]).ravel())
        fd = (gs[0] - gs[1]) / (2 * PROP_FD_POS)
        hess_fd.append({"atom": atom, "axis": axis, "max_abs_diff": float(
            np.abs(hess[:, 3 * atom + axis] - fd).max())})
    alpha = _np(props_call(counts, "polarizability",
                           lambda: P.polarizability(calc)))
    alpha_fd = []
    for axis in range(3):
        f = np.zeros(3)
        f[axis] = PROP_FD_FIELD
        fd = (_dipole_at(calc, f) - _dipole_at(calc, -f)) / (2 * PROP_FD_FIELD)
        alpha_fd.append({"axis": axis, "max_abs_diff": float(
            np.abs(alpha[:, axis] - fd).max())})
    alpha2, da = props_call(counts, "dalpha_dpos",
                            lambda: P._dalpha_dpos(calc))
    da = _np(da)
    da_fd = []
    for atom, axis in ((1, 1),):
        al = []
        for sgn in (1, -1):
            pos = pos0.clone()
            pos[atom, axis] += sgn * PROP_FD_POS
            qd = dq.KS(mol.make_copy(atompos=pos), xc="b3lyp",
                       opts=dq.SCFOptions(tol=PROPS_TOL))
            qd.run()
            al.append(_np(P.polarizability(qd)))
        fd = (al[0] - al[1]) / (2 * PROP_FD_POS)
        da_fd.append({"atom": atom, "axis": axis, "max_abs_diff": float(
            np.abs(da[:, :, 3 * atom + axis] - fd).max())})
    rec = {"system": "H2O (B3LYP/def2-SVP optimum)", "basis": "def2-svp",
           "method": "RKS-B3LYP", "grid": 2, "nao": mol.meta.nao,
           "ngrid": int(calc._theta["grid"]["dvol"].shape[0]),
           "start": H2O_DISTORTED, "optimal_geometry": _np(pos_opt).tolist(),
           "optimum_bfgs": qo.stats["props"]["optimal_geometry"],
           "energy_ha": float(calc.energy()),
           "residual": calc.stats["residual"],
           "freqs_at_optimum_cm1": freqs.tolist(),
           "six_smallest_abs_freqs_cm1": [float(x) for x in small],
           "hessian_fd": hess_fd, "hessian_fd_gate": HESS_FD_GATE,
           "polarizability_au": alpha.tolist(), "alpha_fd": alpha_fd,
           "alpha_fd_gate": ALPHA_FD_GATE,
           "alpha_from_dalpha_call_max_abs_diff": float(
               np.abs(_np(alpha2) - alpha).max()),
           "dalpha_fd": da_fd, "dalpha_fd_gate": DALPHA_FD_GATE,
           "fd_steps": {"position_bohr": PROP_FD_POS,
                        "field_au": PROP_FD_FIELD},
           "calls": counts,
           "seconds": time.perf_counter() - t_phase, "card": smi_line}
    emit({"props_h2o_b3lyp": rec})
    for name, rows, gate in (("hessian", hess_fd, HESS_FD_GATE),
                             ("alpha", alpha_fd, ALPHA_FD_GATE),
                             ("dalpha/dR", da_fd, DALPHA_FD_GATE)):
        for r in rows:
            if not r["max_abs_diff"] <= gate:
                fail(f"props_h2o_b3lyp: {name} vs central differences "
                     f"{r}, gate {gate}")
    if not np.allclose(hess, hess.T, rtol=0, atol=1e-12):
        fail("props_h2o_b3lyp: the Hessian is not symmetric")
    if rec["alpha_from_dalpha_call_max_abs_diff"] > 1e-9:
        fail("props_h2o_b3lyp: the field Hessian of _dalpha_dpos differs "
             "from polarizability")
    real = np.sort(freqs)[-3:]
    if not (real[0] > 1000.0 and small[-1] < 0.5 * real[0]):
        fail(f"props_h2o_b3lyp: frequencies at the optimum {freqs}: three "
             "real modes above 1000 cm^-1, the six others below half the "
             "smallest of them, expected")
    for key in ("hessian_pos", "polarizability", "dalpha_dpos",
                "optimal_geometry"):
        if not all(counts[key][k] > 0
                   for k in ("ds_jk", "ds_dens_gga", "ds_vxc_gga")):
            fail(f"props_h2o_b3lyp: K1-K3 not all launched in {key}: "
                 f"{counts[key]}")
    return rec


def props_benzene(smi_line):
    """The main path's molecule and functional (B3LYP/def2-SVP, grid 2):
    the dipole (0 by symmetry), Theta_zz from equadrupole against the
    density's second moment, and the polarizability, its off-diagonal
    entries and its diagonal against central differences of the dipole;
    then HF's polarizability, whose alpha_xx = alpha_yy no grid breaks.
    The derivatives take the fields as their only leaves."""
    t_phase = time.perf_counter()
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    calc = dq.KS(mol, xc="b3lyp", opts=dq.SCFOptions(tol=PROPS_TOL))
    calc.run()
    torch.cuda.synchronize()
    counts, peaks = {}, {}
    out = {}
    for name, fn in (("edipole", lambda: P.edipole(calc)),
                     ("equadrupole", lambda: P.equadrupole(calc)),
                     ("polarizability",
                      lambda: P.polarizability(calc))):
        torch.cuda.reset_peak_memory_stats()
        out[name] = _np(props_call(counts, name, fn))
        peaks[name] = torch.cuda.max_memory_allocated()
    mu, quad, alpha = out["edipole"], out["equadrupole"], out[
        "polarizability"]
    theta_zz = 0.5 * (2 * quad[2, 2] - quad[0, 0] - quad[1, 1])
    theta_zz_ref = quadrupole_zz(calc)
    fd = {}
    for axis in range(3):
        f = np.zeros(3)
        f[axis] = PROP_FD_FIELD
        col = (_dipole_at(calc, f) - _dipole_at(calc, -f)) / (
            2 * PROP_FD_FIELD)
        fd[axis] = float(col[axis])
    fd_err = {"xyz"[a]: abs(float(alpha[a, a]) - fd[a]) for a in range(3)}
    aniso = float(alpha[0, 0] - alpha[1, 1])
    aniso_fd = fd[0] - fd[1]
    off = alpha - np.diag(np.diag(alpha))
    records = {k: {kk: vv for kk, vv in v.items() if kk != "gmres"}
               | {"gmres": v.get("gmres", [])}
               for k, v in calc.stats["props"].items()}
    rec = {"system": "benzene", "basis": "def2-svp", "method": "RKS-B3LYP",
           "grid": 2, "nao": mol.meta.nao, "energy_ha": float(calc.energy()),
           "energy_minus_anchor_ha": float(calc.energy()) - KS_ANCHOR_HA,
           "edipole_au": mu.tolist(), "theta_zz_au": theta_zz,
           "theta_zz_quadrupole_zz_au": theta_zz_ref,
           "polarizability_au": alpha.tolist(),
           "alpha_xx_minus_yy": aniso,
           "alpha_xx_minus_yy_central_differences": aniso_fd,
           "alpha_max_abs_offdiag": float(np.abs(off).max()),
           "alpha_fd_abs_diff": fd_err, "alpha_fd_gate": ALPHA_FD_GATE,
           "field_step_au": PROP_FD_FIELD,
           "records": records, "peak_device_bytes": peaks, "calls": counts}
    del calc
    free_device()
    # HF on the same molecule: no grid, so alpha_xx = alpha_yy holds
    hf = dq.HF(mol, opts=dq.SCFOptions(tol=PROPS_TOL))
    hf.run()
    torch.cuda.reset_peak_memory_stats()
    alpha_hf = _np(props_call(counts, "polarizability_hf",
                              lambda: P.polarizability(hf)))
    peaks["polarizability_hf"] = torch.cuda.max_memory_allocated()
    rec.update(
        hf_energy_ha=float(hf.energy()),
        hf_energy_minus_anchor_ha=float(hf.energy()) - HF_ANCHOR_HA,
        hf_polarizability_au=alpha_hf.tolist(),
        hf_alpha_xx_minus_yy=float(alpha_hf[0, 0] - alpha_hf[1, 1]),
        hf_alpha_max_abs_offdiag=float(np.abs(
            alpha_hf - np.diag(np.diag(alpha_hf))).max()),
        seconds=time.perf_counter() - t_phase, card=smi_line)
    emit({"props_benzene": rec})
    if abs(rec["energy_minus_anchor_ha"]) > KS_GATE_HA or \
            abs(rec["hf_energy_minus_anchor_ha"]) > 1e-7:
        fail(f"props_benzene: energies {rec['energy_ha']!r}, "
             f"{rec['hf_energy_ha']!r} vs their anchors")
    if float(np.abs(mu).max()) > BENZENE_DIPOLE_GATE:
        fail(f"props_benzene: dipole {mu.tolist()} (0 by symmetry)")
    if abs(theta_zz - theta_zz_ref) > THETA_ZZ_GATE:
        fail(f"props_benzene: Theta_zz {theta_zz!r} vs {theta_zz_ref!r}")
    if rec["alpha_max_abs_offdiag"] > BENZENE_ALPHA_SYM_GATE:
        fail(f"props_benzene: alpha {alpha.tolist()}: off-diagonal entries")
    if max(fd_err.values()) > ALPHA_FD_GATE or \
            abs(aniso - aniso_fd) > 2 * ALPHA_FD_GATE:
        fail(f"props_benzene: alpha vs central differences {fd_err}, "
             f"xx - yy {aniso!r} vs {aniso_fd!r}")
    if abs(rec["hf_alpha_xx_minus_yy"]) > BENZENE_ALPHA_SYM_GATE or \
            rec["hf_alpha_max_abs_offdiag"] > BENZENE_ALPHA_SYM_GATE:
        fail(f"props_benzene: HF alpha {alpha_hf.tolist()} lacks the "
             "symmetry")
    for name in ("edipole", "equadrupole", "polarizability"):
        if not all(counts[name][k] > 0
                   for k in ("ds_jk", "ds_dens_gga", "ds_vxc_gga")):
            fail(f"props_benzene: K1-K3 not all launched in {name}: "
                 f"{counts[name]}")
    if not counts["polarizability_hf"]["ds_jk"] > 0:
        fail(f"props_benzene: K1 not launched in HF's polarizability: "
             f"{counts['polarizability_hf']}")
    return rec


def variational_benzene(smi_line, mol, theta, e_diis):
    """B3LYP benzene by the variational solver (orb_param "ov": 21 x 93
    rotation parameters) from the port's start Fock (SAD), on the main
    path's theta, against the DIIS energy of the same run."""
    calc = dq.KS(mol, xc="b3lyp", variational=True,
                 opts=dq.SCFOptions(orb_param="ov"))
    calc._theta = theta
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    calc.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, launches_sad = path_counts(), sad_counts()
    st = calc.stats
    e = float(calc.energy())
    rec = {"system": "benzene", "basis": "def2-svp", "method": "RKS-B3LYP",
           "orb_param": "ov", "parameters": 21 * 93, "energy_ha": e,
           "minus_diis_ha": e - e_diis,
           "energy_minus_anchor_ha": e - KS_ANCHOR_HA,
           "bfgs_iterations": st["iterations"],
           "evaluations": st["var_evaluations"],
           "status": st["var_message"],
           "grad_max_abs": st["var_grad_max_abs"],
           "residual": st["residual"], "guess": st.get("guess"),
           "sad_s": st.get("sad_s"), "seconds": seconds,
           "launches": launches, "launches_sad": launches_sad,
           "card": smi_line}
    emit({"variational_benzene": rec})
    if not abs(rec["minus_diis_ha"]) <= VAR_GATE_HA:
        fail(f"variational_benzene: {rec['minus_diis_ha']:.3e} Ha from DIIS")
    if rec["guess"] != "sad":
        fail(f"variational_benzene: started from {rec['guess']!r}")
    if not all(launches[k] > 0 for k in ("ds_jk", "ds_dens_gga",
                                         "ds_vxc_gga")):
        fail(f"variational_benzene: K1-K3 not all launched: {launches}")
    return rec



def h_supercell(n, a=PBC_A):
    """The n x n x n supercell of the simple-cubic H lattice of edge a."""
    return "; ".join(f"H {i * a} {j * a} {k * a}" for i in range(n)
                     for j in range(n) for k in range(n))


def pbc_densities(calc, dm):
    """The grid densities of a periodic KS calc at dm (one per spin) through
    the plain version of K2."""
    grid = calc._theta["grid"]
    out = []
    for d in (dm if dm.ndim == 3 else dm[None]):
        rho, gdot = ds_dens_reference(grid["ao"], grid["ao_grad"],
                                      d.contiguous())
        out.append({"rho": rho, "grad": gdot})
    return out


def plain_pbc_energy(calc, dm):
    """The energy of a periodic calc at dm with the densities through the
    plain version of K2 (J and K, and each long-range K, are plain torch
    products on the periodic routes)."""
    eng, theta = calc.engine, calc._theta
    with torch.no_grad():
        j, k = eng.jk_parts(dm, theta)
        if not hasattr(eng, "xc"):
            return float(eng.energy_from_parts(dm, j, k, theta))
        dens = pbc_densities(calc, dm)
        pol = dm.ndim == 3
        exc = torch.sum(integrate._edens_at(
            eng.xc, {"u": dens[0], "d": dens[1]} if pol else dens[0], pol)
            * theta["grid"]["dvol"])
        return float(eng.energy_from_parts(dm, j, k, theta, exc=exc,
                                           klr=eng.lr_parts(dm, theta)))


PBC_STATS = ("jk_mode", "int1e_s", "n_translations", "pair_ft_s",
             "n_gvectors", "n_pair_terms", "vnuc_s", "gdf_s", "naux",
             "becke_s", "ao_tables_s", "grid_s", "ngrid", "n_virtual_atoms",
             "n_ao_translations", "theta_s", "scf_s", "energy_s", "guess")


def pbc_phase(name, sol, xc, anchor, smi_line, opts=None, gate=PBC_GATE_HA):
    """One periodic path from Sol to the energy (HF for xc None, else KS)
    with the launch counts set to 0 just before it and read just after.
    Gates: the SCF converged, the energy within `gate` of its anchor (when
    it has one), the plain path within KS_PLAIN_GATE_HA, tr(D S) = the
    electron count, and the launches: no K1 (periodic J and K are
    reciprocal-space products), and for a GGA K2 and K3 once per spin per
    Fock build, K2 once more per spin for the energy. Returns (calc,
    record)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    calc = (dq.HF(sol, opts=opts) if xc is None
            else dq.KS(sol, xc=xc, opts=opts))
    reset_counts()
    calc.run()
    launches = path_counts()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st, theta = calc.stats, calc._theta
    dm = calc._dm.contiguous()
    e = float(calc.energy())
    e_plain = plain_pbc_energy(calc, dm)
    profile = iteration_profile(calc.engine, theta, dm, smi_line)
    nelec = sum(sol.nelec)
    trace_ds = float(torch.einsum("...ij,ji->", dm, theta["ovlp"]))
    iters = st["iterations"]
    rec = {"nao": sol.meta.nao, "natm": len(sol.zs_int), "xc": xc,
           "exxdiv": calc.opts.exxdiv, "polarized": calc.engine.polarized,
           **{k: st.get(k) for k in PBC_STATS},
           "iterations": iters,
           "s_per_iteration": st["scf_s"] / max(iters, 1),
           "total_s": total_s, "residual": st["residual"],
           "tol": calc.opts.tol, "energy_ha": e, "energy_plain_ha": e_plain,
           "anchor_ha": anchor,
           "energy_minus_anchor_ha": None if anchor is None else e - anchor,
           "launches": launches, "fock_builds": iters + 1,
           "iteration_profile": profile, "trace_dm_ovlp": trace_ds,
           "peak_device_bytes": peak, "card": smi_line}
    if "grid" in theta:
        rec["sum_dvol_rho"] = float(sum(
            torch.sum(theta["grid"]["dvol"] * d["rho"])
            for d in pbc_densities(calc, dm)))
    if not np.isfinite(e) or dm.shape[-1] != sol.meta.nao:
        fail(f"{name}: energy not finite or dm of the wrong shape")
    if not st["residual"] <= calc.opts.tol:
        fail(f"{name}: residual {st['residual']:.3e} above tol "
             f"{calc.opts.tol}")
    if anchor is not None and abs(e - anchor) > gate:
        fail(f"{name}: energy {e!r} vs anchor {anchor!r} (gate {gate})")
    if abs(e - e_plain) > KS_PLAIN_GATE_HA:
        fail(f"{name}: kernel-path energy {e!r} vs plain-path {e_plain!r}")
    if abs(trace_ds - nelec) > 1e-8:
        fail(f"{name}: tr(D S) = {trace_ds!r}, expected {nelec}")
    m = ((2 if calc.engine.polarized else 1)
         * int(xc is not None and calc.engine.xc.family >= 2))
    want_it = {"ds_jk": 0, "ds_dens_gga": m, "ds_vxc_gga": m,
               "ds_jk_eri_lr": 0}
    per_it = profile["port_kernel_launches_per_iteration"]
    if per_it != want_it:
        fail(f"{name}: one iteration launched {per_it}, expected {want_it}")
    builds = iters + 1
    want = {"ds_jk": 0, "ds_dens_gga": builds * m + m,
            "ds_vxc_gga": builds * m, "ds_jk_eri_lr": 0}
    if launches != want:
        fail(f"{name}: the SCF launched {launches} for {builds} Fock builds "
             f"and its energy, expected {want}")
    return calc, rec


def pbc_h27_pbe(smi_line):
    """The main path of the periodic slice at full width: UKS-PBE of H27
    (27 H atoms in a 9-Bohr cube, 3-21G, grid "sg2"; 664,012 wrapped points,
    772 virtual atoms) on the pair-transform route, K2 and K3 once per spin
    per Fock build on its lattice-summed tables. Gates besides pbc_phase's:
    the shapes, the electron count of the grid per cell, K2/K3 at this
    shape against their plain versions; recorded: a second SCF on the same
    theta and a second pair-transform build, each against the first bit
    for bit, and the kernels' times at this shape beside their bound."""
    from dqc_tpu_torch.ops.pbcft import (gcut_estimate, pbc_pair_ft,
                                         pbc_pair_plan)
    sol = dq.Sol(h_supercell(3), np.eye(3) * 3 * PBC_A, basis="3-21g",
                 grid="sg2")
    calc, rec = pbc_phase("pbc_h27_pbe", sol, "pbe", None, smi_line)
    theta, grid = calc._theta, calc._theta["grid"]
    dm = calc._dm.contiguous()
    ng, nao = grid["ao"].shape
    shape = (ng, nao, len(sol.setup_grid().vowner))
    # a second SCF on the same theta, and a second build of the pair
    # transforms: the same bits?
    calc2 = dq.KS(sol, xc="pbe")
    calc2._theta = theta
    calc2.run()
    rec["energy_bit_identical_second_scf"] = (
        float(calc2.energy()) == rec["energy_ha"])
    rec["iterations_second_scf"] = calc2.stats["iterations"]
    del calc2
    lat = sol.lattice
    gv, _ = lat.get_gvgrids(gcut_estimate(sol.meta, sol.params, 1e-9))
    with torch.no_grad():
        fre, fim = pbc_pair_ft(sol.meta, sol.params,
                               pbc_pair_plan(sol.meta, sol.params, lat, 1e-9),
                               gv)
    rec["pair_ft_bit_identical_rebuild"] = bool(
        torch.equal(fre, theta["pbcft"]["Fre"])
        and torch.equal(fim, theta["pbcft"]["Fim"]))
    rec["pair_ft_bytes"] = 2 * fre.numel() * 8
    del fre, fim
    free_device()
    # K2 and K3 at this shape: the converged density of each spin and the
    # real pointwise potentials at it
    ao, ag = grid["ao"], grid["ao_grad"]
    dens = pbc_densities(calc, dm)
    _, vbar = integrate._pointwise_adjoints(
        calc.engine.xc, {"u": dens[0], "d": dens[1]}, grid["dvol"], True,
        None)
    checks = []
    for s, spin in enumerate("ud"):
        checks.append(check_dens(ao, ag, dm[s], f"H27 grid, dm {spin}"))
        checks.append(check_vxc(ao, ag, vbar[spin]["rho"].contiguous(),
                                vbar[spin]["grad"].contiguous(),
                                f"H27 grid, real vrho/vgrad {spin}"))
    vr = vbar["u"]["rho"].contiguous()
    vg = vbar["u"]["grad"].contiguous()
    d0 = dm[0]

    def dens_library():
        c = ao @ d0.T
        (c * ao).sum(-1)
        2.0 * (ag * c).sum(-1)

    def vxc_library():
        w = vr[:, None] * ao + 2.0 * torch.einsum("dg,dgi->gi", vg, ag)
        w.T @ ao

    k2_ms, k2_plain = time_turns(lambda: ds_dens_gga(ao, ag, d0),
                                 lambda: ds_dens_reference(ao, ag, d0))
    k3_ms, k3_plain = time_turns(lambda: ds_vxc_gga(ao, ag, vr, vg),
                                 lambda: ds_vxc_reference(ao, ag, vr, vg))
    k2_bytes = 8 * (4 * ng * nao + nao * nao + 4 * ng)
    k3_bytes = 8 * (4 * ng * nao + 4 * ng + nao * nao)
    flops = 2 * ng * nao * nao + 8 * ng * nao
    kern = {}
    for name, ms, plain, lib, nbytes, cks in (
            ("ds_dens_gga", k2_ms, k2_plain, time_ms(dens_library, 20),
             k2_bytes, checks[0::2]),
            ("ds_vxc_gga", k3_ms, k3_plain, time_ms(vxc_library, 20),
             k3_bytes, checks[1::2])):
        b, by = bound(nbytes, flops)
        kern[name] = {"ng": ng, "nao": nao, "ms": min(ms), "ms_runs": ms,
                      "plain_ms": min(plain), "plain_ms_runs": plain,
                      "library_ms": lib, "bytes_moved": nbytes,
                      "flops": flops, "bound_ms": b, "bound_by": by,
                      "gbytes_per_s": nbytes / (min(ms) * 1e-3) / 1e9,
                      "max_abs_err": max(v for c in cks for k, v in c.items()
                                         if k.endswith("_max_abs_err")),
                      "launches": rec["launches"][name], "card": smi_line}
    rec.update(shape=list(shape), kernel_checks=checks, kernels=kern)
    emit({"pbc_h27_pbe": rec})
    if shape != H27_SHAPE:
        fail(f"pbc_h27_pbe: (ng, nao, virtual atoms) = {shape}, expected "
             f"{H27_SHAPE}")
    natm = len(sol.zs_int)
    if abs(rec["sum_dvol_rho"] - natm) > natm * PBC_NELEC_GATE:
        fail(f"pbc_h27_pbe: sum dvol rho = {rec['sum_dvol_rho']!r}, "
             f"expected {natm} within {natm * PBC_NELEC_GATE}")
    del calc, theta, grid, ao, ag, dm, dens, vbar, vr, vg, d0
    return rec


def pbc_h8(smi_line):
    """The periodic routes on H8 (a 6-Bohr cube, restricted, nao 16)
    against JAX-CPU anchors: HF with exxdiv "ewald" and None, PBE, PBE0,
    CAM-B3LYP (long-range K as full minus short-range on wsr0), and the
    periodic fit with PBE and CAM-B3LYP (its short-range fit df_sr0).
    Returns {phase: record}."""
    def sol(gdf=False):
        s = dq.Sol(h_supercell(2), np.eye(3) * 2 * PBC_A, basis="3-21g",
                   grid="sg2")
        return s.densityfit(method="gdf") if gdf else s

    out = {}
    hf = {}
    for key, exxdiv in (("ewald", "ewald"), ("none", None)):
        anchor = PBC_H8_ANCHORS_HA["hf" if exxdiv else "hf_exxdiv_none"]
        calc, hf[key] = pbc_phase(f"pbc_h8_hf[{key}]", sol(), None, anchor,
                                  smi_line,
                                  opts=dq.SCFOptions(exxdiv=exxdiv))
        hf[key]["madelung"] = calc._theta["pbcft"]["madelung"]
        del calc
    out["pbc_h8_hf"] = hf
    emit({"pbc_h8_hf": hf})
    for xc in ("pbe", "pbe0", "camb3lyp"):
        name = f"pbc_h8_{xc}"
        calc, out[name] = pbc_phase(name, sol(), xc, PBC_H8_ANCHORS_HA[xc],
                                    smi_line)
        out[name]["theta_keys"] = sorted(calc._theta["pbcft"])
        emit({name: out[name]})
        del calc
        free_device()
    for xc in ("pbe", "camb3lyp"):
        name = f"pbc_h8_gdf_{xc}"
        calc, rec = pbc_phase(name, sol(gdf=True), xc,
                              PBC_H8_GDF_ANCHORS_HA[xc], smi_line)
        rec["anchor_own_fit_ha"] = PBC_H8_GDF_OWN_FIT_HA[xc]
        rec["minus_aft_ha"] = rec["energy_ha"] - out[f"pbc_h8_{xc}"][
            "energy_ha"]
        rec["theta_keys"] = sorted(k for k in calc._theta
                                   if k.startswith("df"))
        if calc.jk_mode != "gdf" or "pbcft" in calc._theta:
            fail(f"{name}: route {calc.jk_mode!r}, expected 'gdf'")
        out[name] = rec
        emit({name: rec})
        del calc
        free_device()
    return out


def pbc_h8_forces(smi_line):
    """HF and PBE forces of a distorted H8 by implicit differentiation on
    the card, against central differences of the same energy_fn; the sum of
    the forces (translation invariance) below 1e-8."""
    pos = np.array([[float(v) for v in a.split()[1:]]
                    for a in h_supercell(2).split(";")])
    pos[1] += PBC_DISTORT
    out = {}
    for key, xc in (("hf", None), ("pbe", "pbe")):
        sol = dq.Sol((["H"] * 8, pos), np.eye(3) * 2 * PBC_A, basis="3-21g",
                     grid="sg2")
        calc = dq.HF(sol) if xc is None else dq.KS(sol, xc=xc)
        calc.run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        g = calc.energy_grad()
        launches = _launch_counts()
        F = -g["basis"]["atompos"].detach().cpu().numpy()
        sumF = float(np.abs(F.sum(0)).max())
        rec = {"xc": xc, "energy_ha": float(calc.energy()),
               "scf_iterations": calc.stats["iterations"],
               "grad_s": calc.stats["grad_s"],
               "grad_forward_s": calc.stats["grad_forward_s"],
               "grad_backward_s": calc.stats["grad_backward_s"],
               "gmres": calc.stats["gmres"], "launches_in_gradient": launches,
               "peak_device_bytes_gradient": torch.cuda.max_memory_allocated(),
               "max_abs_sum_F": sumF, "forces": F.tolist(), "card": smi_line}
        central_differences(f"pbc_h8_forces_fd[{key}]", calc, F,
                            PBC_FD_COMPONENTS[key])
        out[key] = rec
        if not np.all(np.isfinite(F)) or F.shape != (8, 3):
            fail(f"pbc_h8_forces[{key}]: forces not finite or of shape "
                 f"{F.shape}")
        if sumF > 1e-8:
            fail(f"pbc_h8_forces[{key}]: sum of the forces {sumF:.3e}")
        if xc is not None and not (launches["ds_dens_gga"] > 0
                                   and launches["ds_vxc_gga"] > 0):
            fail(f"pbc_h8_forces[{key}]: kernels inside the gradient: "
                 f"{launches}")
        del calc, g
        free_device()
    emit({"pbc_h8_forces": out})
    return out


def mp_mesh(dims, edge):
    """The Gamma-centred Monkhorst-Pack mesh of a cubic cell of edge `edge`
    (Bohr): k = 2 pi / edge (i / nx, j / ny, k / nz), (nk, 3) Bohr^-1."""
    b = 2.0 * np.pi / edge
    return np.array([[b * i / dims[0], b * j / dims[1], b * k / dims[2]]
                     for i in range(dims[0]) for j in range(dims[1])
                     for k in range(dims[2])])


def k_trace(calc):
    """sum_k w_k tr(D^k S^k) of a k-point calc (spins summed)."""
    theta = calc._theta
    dmc = kpbc.join(calc._dm)
    return float(torch.einsum("k,...kij,kji->", theta["wk"].to(dmc.dtype),
                              dmc, theta["ovlp"]).real)


def k_plain_energy(calc):
    """The energy of a k-point calc at its converged state with E_xc through
    the plain version (the JAX package's complex einsums on the Bloch
    tables) in place of K2 on the real embedding; J, K and Vne are plain
    torch on either path."""
    eng, theta, x = calc.engine, calc._theta, calc._dm
    with torch.no_grad():
        j, k = eng.jk_parts(x, theta)
        exc = eng.exc_vxc_plain(x, theta)[0] if eng.semilocal else None
        return float(eng.energy_from_parts(x, j, k, theta, exc=exc))


K_STATS = PBC_STATS + ("nk", "exx_s")


def pbc_k_phase(name, sol, xc, anchor, smi_line, opts=None, restricted=None,
                gate=PBC_GATE_HA):
    """One k-point path from Sol to the energy (HF for xc None, else KS) with
    the launch counts set to 0 just before it and read just after. Gates:
    the SCF converged, the energy within `gate` of its anchor (when it has
    one), the plain path within KS_PLAIN_GATE_HA, sum_k w_k tr(D^k S^k) =
    N to K_TRACE_GATE, and the launches: no K1, and for a GGA or meta-GGA
    K2 and K3 once per k-point and spin per Fock build, K2 once more per
    k-point and spin for the energy. Returns (calc, record)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kw = {} if restricted is None else {"restricted": restricted}
    calc = (dq.HF(sol, opts=opts, **kw) if xc is None
            else dq.KS(sol, xc=xc, opts=opts, **kw))
    reset_counts()
    calc.run()
    launches = path_counts()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st, theta, eng = calc.stats, calc._theta, calc.engine
    e = float(calc.energy())
    e_plain = k_plain_energy(calc)
    profile = iteration_profile(eng, theta, calc._dm, smi_line)
    nelec = sum(sol.nelec)
    trace = k_trace(calc)
    iters = st["iterations"]
    rec = {"nao": sol.meta.nao, "natm": len(sol.zs_int), "xc": xc,
           "nk": eng.nk, "kpts": np.asarray(sol.kpts).tolist(),
           "exxdiv": calc.opts.exxdiv, "polarized": eng.polarized,
           **{k: st.get(k) for k in K_STATS},
           "iterations": iters,
           "s_per_iteration": st["scf_s"] / max(iters, 1),
           "total_s": total_s, "residual": st["residual"],
           "residual_history": st["residual_history"][:iters].tolist(),
           "tol": calc.opts.tol, "energy_ha": e, "energy_plain_ha": e_plain,
           "anchor_ha": anchor,
           "energy_minus_anchor_ha": None if anchor is None else e - anchor,
           "launches": launches, "fock_builds": iters + 1,
           "iteration_profile": profile, "trace_dm_ovlp": trace,
           "peak_device_bytes": peak, "card": smi_line}
    if "grid" in theta:
        dens = eng._dens_plain(kpbc.join(calc._dm), theta)
        dens = [dens["u"], dens["d"]] if eng.polarized else [dens]
        rec["sum_dvol_rho"] = float(sum(
            torch.sum(theta["grid"]["dvol"] * d["rho"]) for d in dens))
    if not np.isfinite(e):
        fail(f"{name}: energy not finite")
    if not st["residual"] <= calc.opts.tol:
        fail(f"{name}: residual {st['residual']:.3e} above tol "
             f"{calc.opts.tol}")
    if anchor is not None and abs(e - anchor) > gate:
        fail(f"{name}: energy {e!r} vs anchor {anchor!r} (gate {gate})")
    if abs(e - e_plain) > KS_PLAIN_GATE_HA:
        fail(f"{name}: kernel-path energy {e!r} vs plain-path {e_plain!r}")
    if abs(trace - nelec) > K_TRACE_GATE:
        fail(f"{name}: sum_k w_k tr(D S) = {trace!r}, expected {nelec}")
    m = (eng.nk * (2 if eng.polarized else 1)
         * int(eng.semilocal and eng.xc.family >= 2))
    want_it = {"ds_jk": 0, "ds_dens_gga": m, "ds_vxc_gga": m,
               "ds_jk_eri_lr": 0}
    per_it = profile["port_kernel_launches_per_iteration"]
    if per_it != want_it:
        fail(f"{name}: one iteration launched {per_it}, expected {want_it}")
    builds = iters + 1
    want = {"ds_jk": 0, "ds_dens_gga": builds * m + m,
            "ds_vxc_gga": builds * m, "ds_jk_eri_lr": 0}
    if launches != want:
        fail(f"{name}: the SCF launched {launches} for {builds} Fock builds "
             f"and its energy, expected {want}")
    return calc, rec


def k_band_checks(name, calc, kb, pairs, smi_line):
    """band_energies at the band points kb: each (band index, mesh index)
    of `pairs` against the SCF's own eigenvalues at that mesh point, and
    the first two band points against each other (k and -k: time
    reversal), all to K_BAND_GATE_HA."""
    eng, theta, x = calc.engine, calc._theta, calc._dm
    t0 = time.perf_counter()
    band = dq.band_energies(calc, kb)
    torch.cuda.synchronize()
    rec = {"kpts_band": np.asarray(kb).tolist(),
           "seconds": time.perf_counter() - t0}
    with torch.no_grad():
        eps = eng.eigenvalues(eng.fock(x, theta), theta)
    # directions the basis drops at a k are pinned near LARGE (1e7): left
    # out, their eigenvalues carry rounding of that size
    def gap(a, b):
        keep = (a.abs() < 1e6) & (b.abs() < 1e6)
        return float(torch.where(keep, a - b, torch.zeros_like(a))
                     .abs().max())
    rec["vs_scf"] = [gap(band[..., b, :], eps[..., i, :]) for b, i in pairs]
    rec["time_reversal"] = gap(band[..., 0, :], band[..., 1, :])
    rec["n_pinned"] = int((band.abs() >= 1e6).sum())
    rec["band_ha"] = band.detach().cpu().numpy().tolist()
    for b, err in zip(pairs, rec["vs_scf"]):
        if not err <= K_BAND_GATE_HA:
            fail(f"{name}: band energies at band point {b[0]} differ from "
                 f"the SCF's at mesh point {b[1]} by {err:.3e}")
    if not rec["time_reversal"] <= K_BAND_GATE_HA:
        fail(f"{name}: band energies at k and -k differ by "
             f"{rec['time_reversal']:.3e}")
    return rec


def pbc_k_h8_pbe(smi_line):
    """The main path of the k-point slice at full width: RKS-PBE of H8 (a
    6-Bohr cube, 3-21G, grid "sg2", nao 16) on the Gamma-centred 3x3x3 mesh,
    K2 and K3 once per k-point per Fock build on the real embedding of its
    Bloch tables. Gates besides pbc_k_phase's: the shapes, the grid's
    electron count, K2/K3 on the embedded tables at this shape against
    their plain versions (bit-identical repeats), a second SCF on the same
    theta (the same bits), band_energies at mesh points against the SCF's
    eigenvalues and at k against -k. Recorded: the reckoned sizes, and
    K2's and K3's times at the embedded shape beside their bound."""
    mesh = mp_mesh(K_MAIN_MESH, 2 * PBC_A)
    sol = dq.Sol(h_supercell(2), np.eye(3) * 2 * PBC_A, basis="3-21g",
                 grid="sg2", kpts=mesh)
    calc, rec = pbc_k_phase("pbc_k_h8_pbe", sol, "pbe", None, smi_line)
    eng, theta, grid, x = calc.engine, calc._theta, calc._theta["grid"], \
        calc._dm
    nk, ng, m2 = grid["ao"].shape
    nao = sol.meta.nao
    rec["sizes"] = {
        "nk": nk, "nao": nao, "n_gvectors": rec["n_gvectors"], "ngrid": ng,
        "q_bytes": 2 * theta["Qre"].numel() * 8,
        "bloch_table_bytes": sum(grid[key].numel() * 8 for key in
                                 ("ao", "ao_grad", "ao_lapl") if key in grid),
        "reckoned": {"n_gvectors": 98900, "q_bytes": 10.9e9,
                     "ngrid": 197000, "bloch_table_bytes": 5.4e9}}
    rec["sum_dvol_rho_gamma_h8"] = 7.99996
    # a second SCF on the same theta: the same bits?
    calc2 = dq.KS(sol, xc="pbe")
    calc2._theta = theta
    calc2.run()
    rec["energy_bit_identical_second_scf"] = (
        float(calc2.energy()) == rec["energy_ha"]
        and bool(torch.equal(calc2._dm, x)))
    rec["iterations_second_scf"] = calc2.stats["iterations"]
    del calc2
    # band energies: (1,1,1)/3 of the mesh and its inverse, and Gamma
    i111 = 13
    rec["bands"] = k_band_checks(
        "pbc_k_h8_pbe", calc, np.stack([mesh[i111], -mesh[i111], mesh[0]]),
        ((0, i111), (1, i111), (2, 0)), smi_line)
    free_device()
    # K2 and K3 on the embedded tables of two k-points: the converged D^k
    # embedded with its weight, and the real pointwise potentials at the
    # converged density
    dmc = kpbc.join(x)
    memb = kpbc._embed(dmc, theta["wk"])
    dens = eng._dens_plain(dmc, theta)
    _, vbar = integrate._pointwise_adjoints(eng.xc, dens, grid["dvol"],
                                            False, None)
    vr, vg = vbar["rho"].contiguous(), vbar["grad"].contiguous()
    checks = []
    for k in (0, i111):
        ao, ag = grid["ao"][k], grid["ao_grad"][k]
        checks.append(check_dens(ao, ag, memb[k].contiguous(),
                                 f"H8 3x3x3 embedded table k={k}, w_k M^k"))
        checks.append(check_vxc(ao, ag, vr, vg,
                                f"H8 3x3x3 embedded table k={k}, real "
                                "vrho/vgrad"))
    ao, ag, d0 = grid["ao"][i111], grid["ao_grad"][i111], \
        memb[i111].contiguous()

    def dens_library():
        c = ao @ d0.T
        (c * ao).sum(-1)
        2.0 * (ag * c).sum(-1)

    def vxc_library():
        w = vr[:, None] * ao + 2.0 * torch.einsum("dg,dgi->gi", vg, ag)
        w.T @ ao

    k2_ms, k2_plain = time_turns(lambda: ds_dens_gga(ao, ag, d0),
                                 lambda: ds_dens_reference(ao, ag, d0))
    k3_ms, k3_plain = time_turns(lambda: ds_vxc_gga(ao, ag, vr, vg),
                                 lambda: ds_vxc_reference(ao, ag, vr, vg))
    k2_bytes = 8 * (4 * ng * m2 + m2 * m2 + 4 * ng)
    k3_bytes = 8 * (4 * ng * m2 + 4 * ng + m2 * m2)
    flops = 2 * ng * m2 * m2 + 8 * ng * m2
    kern = {}
    for name, ms, plain, lib, nbytes, cks in (
            ("ds_dens_gga", k2_ms, k2_plain, time_ms(dens_library, 20),
             k2_bytes, checks[0::2]),
            ("ds_vxc_gga", k3_ms, k3_plain, time_ms(vxc_library, 20),
             k3_bytes, checks[1::2])):
        b, by = bound(nbytes, flops)
        kern[name] = {"ng": ng, "nao_embedded": m2, "ms": min(ms),
                      "ms_runs": ms, "plain_ms": min(plain),
                      "plain_ms_runs": plain, "library_ms": lib,
                      "bytes_moved": nbytes, "flops": flops, "bound_ms": b,
                      "bound_by": by,
                      "gbytes_per_s": nbytes / (min(ms) * 1e-3) / 1e9,
                      "max_abs_err": max(v for c in cks for k, v in c.items()
                                         if k.endswith("_max_abs_err")),
                      "launches": rec["launches"][name],
                      "launches_per_fock_build": nk, "card": smi_line}
    rec.update(kernel_checks=checks, kernels=kern)
    emit({"pbc_k_h8_pbe": rec})
    if (nk, nao) != K_MAIN_SHAPE or m2 != 2 * nao:
        fail(f"pbc_k_h8_pbe: (nk, nao) = {(nk, nao)}, tables of width {m2}; "
             f"expected {K_MAIN_SHAPE}")
    if abs(rec["sum_dvol_rho"] - 8) > 8 * PBC_NELEC_GATE:
        fail(f"pbc_k_h8_pbe: sum dvol rho = {rec['sum_dvol_rho']!r}, "
             f"expected 8 within {8 * PBC_NELEC_GATE}")
    if not rec["energy_bit_identical_second_scf"]:
        fail("pbc_k_h8_pbe: a second SCF on the same theta gave other bits")
    del calc, theta, grid, x, dmc, memb, dens, vbar, vr, vg, ao, ag, d0
    return rec


# the functionals of the Bloch check: HF only. Its PBE case (51 s of H24's
# Becke weights on the card) is cut to pay for the batch phase; the k-point
# PBE path stays held by pbc_k_h8_pbe and its JAX-CPU anchor
BLOCH_CASES = (("hf", None),)


def pbc_k_bloch(smi_line):
    """Bloch's theorem at complex phases on the card: H8 on a 3x1x1 mesh
    against the Gamma path on H24, the supercell tripled along x, per H8
    cell, for the functionals of BLOCH_CASES (K_BLOCH_GATES_HA)."""
    mesh = mp_mesh((3, 1, 1), 2 * PBC_A)
    h8 = [[float(v) for v in a.split()[1:]] for a in h_supercell(2).split(";")]
    h24 = "; ".join(f"H {p[0] + 2 * PBC_A * c} {p[1]} {p[2]}"
                    for c in range(3) for p in h8)
    out = {}
    for key, xc in BLOCH_CASES:
        sk = dq.Sol(h_supercell(2), np.eye(3) * 2 * PBC_A, basis="3-21g",
                    grid="sg2", kpts=mesh)
        calc, rk = pbc_k_phase(f"pbc_k_bloch[{key}_3x1x1]", sk, xc, None,
                               smi_line)
        del calc
        free_device()
        s24 = dq.Sol(h24, np.diag([6 * PBC_A, 2 * PBC_A, 2 * PBC_A]),
                     basis="3-21g", grid="sg2")
        calc, r24 = pbc_phase(f"pbc_k_bloch[{key}_h24]", s24, xc, None,
                              smi_line)
        del calc
        free_device()
        diff = rk["energy_ha"] - r24["energy_ha"] / 3
        out[key] = {"kmesh": rk, "h24": r24, "per_cell_diff_ha": diff,
                    "gate_ha": K_BLOCH_GATES_HA[key]}
        if not abs(diff) <= K_BLOCH_GATES_HA[key]:
            fail(f"pbc_k_bloch[{key}]: k-mesh {rk['energy_ha']!r} vs H24 / 3 "
                 f"{r24['energy_ha'] / 3!r} (gate {K_BLOCH_GATES_HA[key]})")
    emit({"pbc_k_bloch": out})
    return out


K3_CASES = (("hf_ewald", None, "ewald", None, False),
            ("hf_none", None, None, None, False),
            ("pbe", "pbe", "ewald", None, False),
            ("pbe0", "pbe0", "ewald", None, False),
            ("camb3lyp", "camb3lyp", "ewald", None, False),
            ("scan", "scan", "ewald", None, False),
            ("uks_pbe", "pbe", "ewald", False, False),
            ("gdf_pbe", "pbe", "ewald", None, True))


def pbc_k_h8_3mesh(smi_line):
    """Every k-point route on H8 with the three-point mesh along x against
    its JAX-CPU anchor (PBC_GATE_HA): HF with exxdiv "ewald" and None, PBE,
    PBE0, CAM-B3LYP (LR = full - SR), SCAN, UKS-PBE and the k-point fit
    with PBE. Returns {phase: record}."""
    out = {}
    for key, xc, exxdiv, restricted, gdf in K3_CASES:
        name = f"pbc_k_h8_3mesh_{key}"
        sol = dq.Sol(h_supercell(2), np.eye(3) * 2 * PBC_A, basis="3-21g",
                     grid="sg2", kpts=mp_mesh((3, 1, 1), 2 * PBC_A))
        if gdf:
            sol = sol.densityfit(method="gdf")
        calc, rec = pbc_k_phase(name, sol, xc, PBC_K3_ANCHORS_HA[key],
                                smi_line, opts=dq.SCFOptions(exxdiv=exxdiv),
                                restricted=restricted)
        if "exx" in calc._theta:
            rec["madelung"] = calc._theta["exx"]["madelung"]
        if gdf and (calc.jk_mode != "gdf" or "kdf" not in calc._theta):
            fail(f"{name}: route {calc.jk_mode!r}, expected 'gdf'")
        out[name] = rec
        emit({name: rec})
        del calc
        free_device()
    return out


def pbc_k_h8_pbe0_222(smi_line):
    """A hybrid at a real mesh: PBE0 on the 2x2x2 mesh of H8's cell with its
    atoms paired into H2 along x (K_PAIRED_X; the mixed (k, k') pair-
    transform stack of its exchange, 25.9 GB, as for H8). Gates: those of
    pbc_k_phase, and the band energies at an off-mesh k against -k (time
    reversal). Recorded: seconds, the stack's bytes, peak memory."""
    mesh = mp_mesh((2, 2, 2), 2 * PBC_A)
    paired = "; ".join(f"H {x} {PBC_A * j} {PBC_A * k}" for x in K_PAIRED_X
                       for j in range(2) for k in range(2))
    sol = dq.Sol(paired, np.eye(3) * 2 * PBC_A, basis="3-21g", grid="sg2",
                 kpts=mesh)
    calc, rec = pbc_k_phase("pbc_k_h8_pbe0_222", sol, "pbe0", None, smi_line)
    rec["exx_stack_bytes"] = calc._theta["exx"]["A"].numel() * 16
    kb = 2 * np.pi / (2 * PBC_A) * np.array([[0.25, 0.1, 0.0],
                                             [-0.25, -0.1, 0.0]])
    rec["bands"] = k_band_checks("pbc_k_h8_pbe0_222", calc, kb, (), smi_line)
    emit({"pbc_k_h8_pbe0_222": rec})
    del calc
    return rec


def pbc_k_forces(smi_line):
    """HF and PBE forces of the k-point force cell by implicit
    differentiation on the card, against central differences of the same
    energy_fn (FD_GATE); the sum of the forces below 1e-8."""
    out = {}
    for key, xc in (("hf", None), ("pbe", "pbe")):
        sol = dq.Sol(K_FORCE_DESC, np.eye(3) * PBC_A, basis="3-21g",
                     grid="sg2", kpts=np.array(K_FORCE_MESH))
        calc = dq.HF(sol) if xc is None else dq.KS(sol, xc=xc)
        calc.run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        g = calc.energy_grad()
        launches = _launch_counts()
        F = -g["basis"]["atompos"].detach().cpu().numpy()
        sumF = float(np.abs(F.sum(0)).max())
        rec = {"xc": xc, "energy_ha": float(calc.energy()),
               "scf_iterations": calc.stats["iterations"],
               "grad_s": calc.stats["grad_s"],
               "grad_forward_s": calc.stats["grad_forward_s"],
               "grad_backward_s": calc.stats["grad_backward_s"],
               "gmres": calc.stats["gmres"], "launches_in_gradient": launches,
               "peak_device_bytes_gradient": torch.cuda.max_memory_allocated(),
               "max_abs_sum_F": sumF, "forces": F.tolist(), "card": smi_line}
        central_differences(f"pbc_k_forces_fd[{key}]", calc, F,
                            K_FORCE_COMPONENTS)
        out[key] = rec
        if not np.all(np.isfinite(F)) or F.shape != (2, 3):
            fail(f"pbc_k_forces[{key}]: forces not finite or of shape "
                 f"{F.shape}")
        if sumF > 1e-8:
            fail(f"pbc_k_forces[{key}]: sum of the forces {sumF:.3e}")
        if xc is not None and not (launches["ds_dens_gga"] > 0
                                   and launches["ds_vxc_gga"] > 0):
            fail(f"pbc_k_forces[{key}]: kernels inside the gradient: "
                 f"{launches}")
        del calc, g
        free_device()
    emit({"pbc_k_forces": out})
    return out


# --- the batch on every route (parallel/batch.energy_batch) -----------------

BATCH_GAMMA = 2                  # H8 cells of batch_pbc_gamma
BATCH_PAIR = 2                   # members of the other route batches
BATCH_VAR_GATE_HA = 1e-9         # streamed and variational members
BATCH_GRAD_GATE_REL = 1e-9       # the Gamma batch's position gradient


@contextmanager
def batch_captured():
    """parallel/batch's build_theta_batch and solve_batch recording what
    they return while energy_batch runs inside (the stacked theta and the
    members' converged states, for the checks after it)."""
    from dqc_tpu_torch.parallel import batch as pbatch
    got = {}
    build, solve = pbatch.build_theta_batch, pbatch.solve_batch

    def keep_theta(*args, **kwargs):
        got["theta"] = build(*args, **kwargs)
        return got["theta"]

    def keep_dm(*args, **kwargs):
        got["dm"] = solve(*args, **kwargs)
        return got["dm"]
    pbatch.build_theta_batch, pbatch.solve_batch = keep_theta, keep_dm
    try:
        yield got
    finally:
        pbatch.build_theta_batch, pbatch.solve_batch = build, solve


def batch_positions(pos0, nb, seed, first_undisplaced=False):
    """nb members' positions: pos0 plus BATCH_SIGMA_BOHR of seeded noise
    each (member 0 at pos0 itself with first_undisplaced)."""
    rng = np.random.default_rng(seed)
    pos = pos0 + BATCH_SIGMA_BOHR * rng.standard_normal((nb,) + pos0.shape)
    if first_undisplaced:
        pos[0] = pos0
    return pos


def batch_route_phase(name, calc, pos_b, smi_line, refs=None,
                      gate=BATCH_MEMBER_GATE_HA, per_build=None,
                      profile=True):
    """One batched path from the calc to the members' energies: the launch
    counts set to 0 just before energy_batch and read just after; then on
    the stacked theta and states it produced one batched Fock build's
    launches (against per_build, each kernel once for all members: one
    per k-point and spin on the k-point engine), and a steady batched
    iteration under the profiler. Each member m against refs[m] where
    given (an energy of this run), else against the unbatched energy_fn at
    its geometry on the same route (its own theta, built by the calc's
    _build_theta from the member's params), within gate. The
    residuals are gated at tol on the DIIS routes (the variational
    solver's stop is its gradient). Returns (record, theta_b, dm_b)."""
    from dqc_tpu_torch.parallel import batch as pbatch
    from dqc_tpu_torch.utils.datastruct import batch_params, member_params
    pb = batch_params(calc._all_params(), pos_b)
    torch.cuda.synchronize()
    free_device()
    torch.cuda.reset_peak_memory_stats()
    st = {}
    reset_counts()
    t0 = time.perf_counter()
    with batch_captured() as got, torch.no_grad():
        es = pbatch.energy_batch(calc, pb, st)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches, launches_sad = path_counts(), sad_counts()
    peak = torch.cuda.max_memory_allocated()
    theta_b, dm_b = got["theta"], got["dm"]
    es_np = es.cpu().numpy()
    eng = calc.engine
    reset_counts()
    with torch.no_grad():
        eng.fock(dm_b, theta_b)
    build = path_counts()
    rec = {"batch": len(pos_b), "route": calc.jk_mode,
           "method": calc.opts.method, "energies_ha": es_np.tolist(),
           "theta_s": st["theta_s"], "scf_s": st["scf_s"],
           "total_s": total_s, "iterations": st["iterations"],
           "residual": st["residual"], "tol": calc.opts.tol,
           "launches": launches, "launches_sad": launches_sad,
           "launches_per_fock_build": build, "peak_device_bytes": peak,
           "sigma_bohr": BATCH_SIGMA_BOHR, "card": smi_line}
    for key in ("jk_blocks_bytes_batch", "ri_iterations",
                "dual_inner_iterations", "exact_jk", "var_evaluations",
                "var_status", "var_grad_max_abs"):
        if key in st:
            rec[key] = st[key]
    if profile:
        rec["iteration_profile"] = iteration_profile(eng, theta_b, dm_b,
                                                     smi_line)
    if not np.all(np.isfinite(es_np)) or es_np.shape != (len(pos_b),):
        fail(f"{name}: energies {es_np}")
    if (calc.opts.method == "diis"
            and not max(st["residual"]) <= calc.opts.tol):
        fail(f"{name}: residuals {st['residual']} above tol")
    if per_build is not None and build != per_build:
        fail(f"{name}: one batched Fock build launched {build}, expected "
             f"{per_build}")
    members = {}
    for m in range(len(pos_b)):
        tm = time.perf_counter()
        if refs is not None and refs[m] is not None:
            em, how = refs[m], "this run's unbatched phase"
        else:
            with torch.no_grad():
                em = float(calc.energy_fn(member_params(pb, m)))
            how = "unbatched energy_fn"
        members[str(m)] = {"unbatched_ha": em, "batched_ha": float(es_np[m]),
                           "diff_ha": float(es_np[m]) - em, "against": how,
                           "seconds": time.perf_counter() - tm}
    rec["members_vs_unbatched"] = members
    rec["member_gate_ha"] = gate
    for m, r in members.items():
        if not abs(r["diff_ha"]) <= gate:
            fail(f"{name}: member {m} {r['batched_ha']!r} vs unbatched "
                 f"{r['unbatched_ha']!r} (gate {gate})")
    return rec, theta_b, dm_b


def batched_kernel_checks_strided(eng, theta_b, dm_b, k, smi_line):
    """K2 and K3 on the members' tables at k-point k of a batch of k-point
    cells: views of (B, nk, ng, 2 nao) whose member stride is nk ng 2 nao,
    read in place. Against the plain version member by member (rel <=
    GATE_REL), against the same call on a contiguous copy (bit for bit),
    one launch per call, repeats bit for bit; the time beside the plain
    version's (the member loop), one batched PyTorch call's and the
    bound."""
    grid = theta_b["grid"]
    ao, ag = grid["ao"][:, k], grid["ao_grad"][:, k]
    nb, ng, m2 = ao.shape
    with torch.no_grad():
        dmc = kpbc.join(dm_b, True)
        memb = kpbc._embed(dmc, theta_b["wk"])[:, k].contiguous()
        dens = eng._dens(dmc, theta_b)
        _, vbar = integrate._pointwise_adjoints(eng.xc, dens, grid["dvol"],
                                                False, None)
    vr, vg = vbar["rho"].contiguous(), vbar["grad"].contiguous()
    aoc, agc = ao.contiguous(), ag.contiguous()
    recs = []
    for name, kern, plain, args, argsc in (
            ("ds_dens_gga", ds_dens_gga, ds_dens_reference, (ao, ag, memb),
             (aoc, agc, memb)),
            ("ds_vxc_gga", ds_vxc_gga, ds_vxc_reference, (ao, ag, vr, vg),
             (aoc, agc, vr, vg))):
        before = _launch_counts()[name]
        o1 = kern(*args)
        n1 = _launch_counts()[name] - before
        o2, oc, ref = kern(*args), kern(*argsc), plain(*args)
        torch.cuda.synchronize()
        o1, o2, oc, ref = (x if isinstance(x, tuple) else (x,)
                           for x in (o1, o2, oc, ref))
        rec = {"kernel": name, "batch": nb, "k": k, "ng": ng,
               "nao_embedded": m2, "member_stride": ao.stride(0),
               "launches_per_call": n1, "max_abs_err": 0.0,
               "max_rel_err": 0.0,
               "bit_identical_to_contiguous": all(
                   torch.equal(x, y) for x, y in zip(o1, oc)),
               "bit_identical_repeat": all(
                   torch.equal(x, y) for x, y in zip(o1, o2))}
        for x, r in zip(o1, ref):
            scale = r.abs().amax(dim=tuple(range(1, r.ndim)))
            err = (x - r).abs().amax(dim=tuple(range(1, r.ndim)))
            rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
            rec["max_rel_err"] = max(rec["max_rel_err"],
                                     float((err / scale).max()))
        recs.append(rec)
        if not rec["max_rel_err"] <= GATE_REL:
            fail(f"strided {name}: rel err {rec['max_rel_err']:.3e}")
        if not rec["bit_identical_to_contiguous"]:
            fail(f"strided {name}: differs from the call on a contiguous "
                 "copy")
        if not rec["bit_identical_repeat"]:
            fail(f"strided {name}: two calls differ")
        if n1 != 1:
            fail(f"strided {name}: {n1} launches per call")

    def k2_library():
        c = ao @ memb.mT
        (c * ao).sum(-1)
        2.0 * (ag * c[:, None]).sum(-1)

    def k3_library():
        w = vr[..., None] * ao + 2.0 * torch.einsum("bdg,bdgi->bgi", vg, ag)
        w.mT @ ao
    nbytes = 8 * nb * (4 * ng * m2 + m2 * m2 + 4 * ng)
    flops = nb * (2 * ng * m2 * m2 + 8 * ng * m2)
    timing = {}
    for name, kern, plain, args, lib in (
            ("ds_dens_gga", ds_dens_gga, ds_dens_reference, (ao, ag, memb),
             k2_library),
            ("ds_vxc_gga", ds_vxc_gga, ds_vxc_reference, (ao, ag, vr, vg),
             k3_library)):
        ms, pl = time_turns(lambda: kern(*args), lambda: plain(*args))
        bms, by = bound(nbytes, flops)
        chk = next(r for r in recs if r["kernel"] == name)
        timing[name] = {"batch": nb, "k": k, "ng": ng, "nao_embedded": m2,
                        "member_stride": ao.stride(0),
                        "max_abs_err": chk["max_abs_err"],
                        "max_rel_err": chk["max_rel_err"],
                        "bit_identical_to_contiguous":
                            chk["bit_identical_to_contiguous"],
                        "ms": min(ms),
                        "ms_runs": ms, "plain_ms": min(pl),
                        "plain_ms_runs": pl, "library_ms": time_ms(lib, 20),
                        "bytes_moved": nbytes, "flops": flops,
                        "bound_ms": bms, "bound_by": by,
                        "bound_share": bms / min(ms), "card": smi_line}
    return recs, timing


def batch_kpbc(smi_line, k_main):
    """This slice's main path at full width: RKS-PBE of H8 (3-21G, "sg2")
    on the Gamma-centred 3x3x3 mesh (27 k-points, (195,894, 32) embedded
    tables), B = 2 cells through one batched SCF: member 0 the undisplaced
    cell, held to pbc_k_h8_pbe's energy of this run; member 1 displaced by
    BATCH_SIGMA_BOHR (seeded), held to its unbatched energy_fn. K2 and K3
    27 times each per batched Fock build (one launch per k-point for both
    members, on strided views of their tables), and the SCF's launches as
    its Fock builds give them. Records the seconds of theta and the SCF,
    iterations per member, a steady batched iteration under the profiler,
    the peak, and K2/K3 on the strided view at k = (1,1,1)/3."""
    mesh = mp_mesh(K_MAIN_MESH, 2 * PBC_A)
    sol = dq.Sol(h_supercell(2), np.eye(3) * 2 * PBC_A, basis="3-21g",
                 grid="sg2", kpts=mesh)
    calc = dq.KS(sol, xc="pbe")
    nk = len(mesh)
    pos_b = batch_positions(sol.atompos.detach().cpu().numpy(), BATCH_PAIR,
                            BATCH_SEED + 3, first_undisplaced=True)
    per_build = {"ds_jk": 0, "ds_dens_gga": nk, "ds_vxc_gga": nk,
                 "ds_jk_eri_lr": 0}
    rec, theta_b, dm_b = batch_route_phase(
        "batch_kpbc", calc, pos_b, smi_line,
        refs=[k_main["energy_ha"], None], per_build=per_build)
    builds = max(rec["iterations"]) + 1
    want = {"ds_jk": 0, "ds_dens_gga": nk * (builds + 1),
            "ds_vxc_gga": nk * builds, "ds_jk_eri_lr": 0}
    rec.update(system="H8", basis="3-21g", grid="sg2", xc="pbe", nk=nk,
               fock_builds=builds,
               reckoned_theta_bytes_per_member=16.4e9,
               theta_bytes=sum(t.numel() * t.element_size() for t in
                               _tensors_of(theta_b)))
    checks, timing = batched_kernel_checks_strided(calc.engine, theta_b,
                                                   dm_b, 13, smi_line)
    rec.update(kernel_checks_strided=checks, kernels_strided=timing)
    emit({"batch_kpbc": rec})
    if rec["launches"] != want:
        fail(f"batch_kpbc: the batched SCF launched {rec['launches']} for "
             f"{builds} Fock builds and the energies, expected {want}")
    del theta_b, dm_b
    return rec


def _tensors_of(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors_of(v)]
    return []


def batch_pbc_gamma(smi_line):
    """BATCH_GAMMA displaced H8 cells at the Gamma point (3-21G, "sg2",
    seeded BATCH_SIGMA_BOHR displacements) through one batched SCF each:
    RKS-PBE on the pair-transform route and PBE0 on the periodic fit,
    every member held to its unbatched energy_fn, which builds its own
    theta; K2 and K3 once per batched Fock build. The position gradient
    of the HF energies' sum (pair transforms, exact exchange with its
    Madelung term; tol 1e-11) held to the members' energy_grad
    (BATCH_GRAD_GATE_REL)."""
    from dqc_tpu_torch.parallel import batch as pbatch
    from dqc_tpu_torch.utils.datastruct import batch_params, member_params

    def sol(gdf=False):
        s = dq.Sol(h_supercell(2), np.eye(3) * 2 * PBC_A, basis="3-21g",
                   grid="sg2")
        return s.densityfit(method="gdf") if gdf else s
    pos0 = sol().atompos.detach().cpu().numpy()
    pos_b = batch_positions(pos0, BATCH_GAMMA, BATCH_SEED + 4)
    per_build = {"ds_jk": 0, "ds_dens_gga": 1, "ds_vxc_gga": 1,
                 "ds_jk_eri_lr": 0}
    out = {}
    for key, xc, gdf in (("pbe", "pbe", False), ("pbe0_gdf", "pbe0", True)):
        cell = sol(gdf)
        calc = dq.KS(cell, xc=xc)
        rec, theta_b, dm_b = batch_route_phase(
            f"batch_pbc_gamma[{key}]", calc, pos_b, smi_line,
            per_build=per_build)
        builds = max(rec["iterations"]) + 1
        want = {"ds_jk": 0, "ds_dens_gga": builds + 1,
                "ds_vxc_gga": builds, "ds_jk_eri_lr": 0}
        rec.update(xc=xc, fock_builds=builds)
        del theta_b, dm_b
        if rec["launches"] != want:
            fail(f"batch_pbc_gamma[{key}]: launched {rec['launches']} for "
                 f"{builds} Fock builds and the energies, expected {want}")
        out[key] = rec
        del calc
        free_device()
    # the position gradient of the summed HF energies
    calc = dq.HF(sol(), opts=dq.SCFOptions(tol=1e-11))
    pb = batch_params(calc._all_params(), pos_b)
    x = pb["basis"]["atompos"].clone().requires_grad_(True)
    pb["basis"] = dict(pb["basis"], atompos=x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = {}
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(pbatch.energy_batch(calc, pb, st).sum(), x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    ref = torch.stack([calc.energy_grad(member_params(pb, m))["basis"][
        "atompos"] for m in range(BATCH_GAMMA)])
    t2 = time.perf_counter()
    rel = float((g - ref).abs().max() / ref.abs().max())
    out["hf_gradient"] = {
        "batch": BATCH_GAMMA, "xc": None, "tol": 1e-11,
        "max_abs_grad": float(ref.abs().max()), "rel_err_vs_members": rel,
        "gate_rel": BATCH_GRAD_GATE_REL, "batch_grad_s": t1 - t0,
        "members_grad_s": t2 - t1, "gmres": st["gmres"],
        "iterations": st["iterations"], "peak_device_bytes": peak,
        "card": smi_line}
    emit({"batch_pbc_gamma": out})
    if not rel <= BATCH_GRAD_GATE_REL:
        fail(f"batch_pbc_gamma: the batch's position gradient is {rel:.3e} "
             "from the members' energy_grad")
    return out


def batch_molecule(name, smi_line, limits, e0, xc="b3lyp", opts=None,
                   gate=BATCH_MEMBER_GATE_HA, per_build=None):
    """Two benzene/def2-SVP geometries through one batched SCF on the route
    that `limits` (route_limits' keywords) gives: member 0 the main path's
    geometry, held to e0, the unbatched energy of this run's phase on the
    same route and solver; member 1 displaced by BATCH_SIGMA_BOHR (seeded),
    held to its unbatched energy_fn. Returns (calc, record, stacked theta,
    states)."""
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    with route_limits(**limits):
        calc = dq.KS(mol, xc=xc, opts=opts)
        pos_b = batch_positions(mol.atompos.detach().cpu().numpy(),
                                BATCH_PAIR, BATCH_SEED + 5,
                                first_undisplaced=True)
        rec, theta_b, dm_b = batch_route_phase(
            name, calc, pos_b, smi_line, refs=[e0, None], gate=gate,
            per_build=per_build,
            profile=calc.opts.method == "diis" and calc.jk_mode != "stream")
    rec.update(system="benzene", basis="def2-svp", grid=2, xc=xc,
               limits=limits)
    return calc, rec, theta_b, dm_b


def batch_blocked(smi_line, blocked_rec):
    """batch_molecule on the blocked route (the dense limit 0; member 0
    held to blocked_b3lyp): the stack holds both members' quartet blocks;
    K2 and K3 once per batched Fock build, no K1 outside the SAD atoms."""
    per_build = {"ds_jk": 0, "ds_dens_gga": 1, "ds_vxc_gga": 1,
                 "ds_jk_eri_lr": 0}
    _, rec, _, _ = batch_molecule("batch_blocked", smi_line, {"dense": 0},
                                  blocked_rec["energy_ha"],
                                  per_build=per_build)
    builds = max(rec["iterations"]) + 1
    want = dict(per_build, ds_dens_gga=builds + 1, ds_vxc_gga=builds)
    rec["fock_builds"] = builds
    emit({"batch_blocked": rec})
    if rec["route"] != "blocked":
        fail(f"batch_blocked: route {rec['route']!r}")
    if rec["launches"] != want:
        fail(f"batch_blocked: launched {rec['launches']} for {builds} Fock "
             f"builds and the energies, expected {want}")
    return rec


def batch_stream(smi_line, stream_rec):
    """batch_molecule on the streamed route (both limits 0; member 0 held
    to stream_b3lyp): the batched RI phase, then one exact streamed build
    per running member per outer cycle, stops per member; members within
    BATCH_VAR_GATE_HA of the unbatched streamed SCF."""
    per_build = {"ds_jk": 0, "ds_dens_gga": 1, "ds_vxc_gga": 1,
                 "ds_jk_eri_lr": 0}
    _, rec, _, _ = batch_molecule("batch_stream", smi_line,
                                  {"dense": 0, "blocked": 0},
                                  stream_rec["energy_ha"],
                                  gate=BATCH_VAR_GATE_HA,
                                  per_build=per_build)
    emit({"batch_stream": rec})
    if rec["route"] != "stream":
        fail(f"batch_stream: route {rec['route']!r}")
    if rec["launches"]["ds_jk"] != 0 or not all(
            r["builds"] >= 1 for r in rec["exact_jk"]):
        fail(f"batch_stream: launches {rec['launches']}, exact builds "
             f"{rec['exact_jk']}")
    return rec


def batch_variational(smi_line, var_rec):
    """Two benzene B3LYP geometries by the variational solver ("ov"): one
    BFGS over both members' parameters, the sum of their energies from one
    batched evaluation each call (K1 once for both members), each member
    within BATCH_VAR_GATE_HA of its unbatched variational energy (member 0
    of variational_benzene's). Records
    BFGS iterations and evaluations, and K1 launches per evaluation."""
    opts = dq.SCFOptions(method="variational", orb_param="ov")
    calc, rec, theta_b, dm_b = batch_molecule(
        "batch_variational", smi_line, {}, var_rec["energy_ha"],
        opts=opts, gate=BATCH_VAR_GATE_HA)
    evals = rec["var_evaluations"]
    # one batched energy, the function BFGS evaluates, on the stacked theta
    # at the members' converged states
    reset_counts()
    with torch.no_grad():
        calc.engine.energy(dm_b, theta_b)
    per_eval = path_counts()
    del theta_b, dm_b
    rec.update(bfgs_iterations=rec["iterations"], evaluations=evals,
               launches_per_evaluation=per_eval,
               k1_launches_per_evaluation_in_scf=(
                   rec["launches"]["ds_jk"] / max(evals, 1)))
    emit({"batch_variational": rec})
    if per_eval["ds_jk"] != 1:
        fail(f"batch_variational: one batched energy launched {per_eval}")
    return rec


def main():
    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    emit({"device": {"name": torch.cuda.get_device_name(0),
                     "nvidia_smi": smi_line, "torch": torch.__version__,
                     "cuda": torch.version.cuda,
                     "count": torch.cuda.device_count()}})
    print(smi_line, flush=True)

    # 2. build: one nvcc per source, all started together
    names = ("ds_jk", "ds_dens_gga", "ds_vxc_gga")
    t_build = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(
            lambda nm: _nvcc.build(nm, force=True), names)))
    emit({"build": {nm: {"source": f"dqc_tpu_torch/csrc/{nm}.cu",
                         "seconds": b["seconds"],
                         "resources": ptxas_summary(b["log"]),
                         "ptxas": b["log"]}
                    for nm, b in builds.items()},
          "seconds": time.perf_counter() - t_build})

    # 3. the kernel against its plain version on seeded tensors
    checks = []
    for n in (7, 10, 18, 33, 66, 114):
        T = eri_like(n, seed=2)
        checks.append(check_kernel(T, sym_dm(n, 3), f"eri_like({n})"))
        # a non-symmetric density matrix as well: the kernel must not rely
        # on the symmetry
        if n == 33:
            rng = np.random.default_rng(4)
            dmx = torch.as_tensor(rng.standard_normal((n, n)), device=DEV)
            checks.append(check_kernel(T, dmx, f"eri_like({n}) nonsym dm"))
        del T
    # the sizes past benzene's, made on the card: dm no longer fits in
    # shared memory beside the ring (jk_plan's dm_shared = 0), so its rows
    # are streamed with T's
    for n in (150, 171):
        T = card_like(n, seed=n)
        rng = np.random.default_rng(n)
        dmx = rng.standard_normal((n, n))
        checks.append(check_kernel(T, torch.as_tensor(dmx + dmx.T, device=DEV),
                                   f"card_like({n})"))
        checks.append(check_kernel(T, torch.as_tensor(dmx, device=DEV),
                                   f"card_like({n}) nonsym dm"))
        del T
        free_device()
    emit({"kernel_checks": checks, "gate_rel": GATE_REL})

    # 4. the main path: HF on benzene/def2-SVP. Every path's launches are
    # its molecule's own: those of the SAD start's atomic SCFs are counted
    # apart
    qccalc.sad_dm0 = _count_sad(qccalc.sad_dm0)
    eri._auto_block = _record_auto_block(eri._auto_block)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mol = dq.Mol(benzene_desc(), basis="def2-svp")
    calc = dq.HF(mol)
    reset_counts()
    calc.run()
    hf_launches = path_counts()
    hf_sad = sad_counts()
    launches = hf_launches["ds_jk"]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    st = calc.stats
    theta = calc._theta
    dm = calc.aodm()
    e_kernel = float(calc.energy())
    nao = mol.meta.nao
    k_ref, j_ref = ds_jk_reference(theta["eri_k"], dm)
    e_plain = float(calc.engine.energy_from_parts(dm, j_ref, k_ref, theta))
    trace_ds = float(torch.einsum("ij,ji->", dm, theta["ovlp"]))
    main = {
        "system": "benzene", "basis": "def2-svp", "method": "RHF",
        "nao": nao, "device": str(mol.device),
        "int1e_s": st["int1e_s"], "eri_dense_s": st["eri_s"],
        "scf_s": st["scf_s"], "iterations": st["iterations"],
        "s_per_iteration": (st["scf_s"] - st.get("sad_s", 0.0))
        / max(st["iterations"], 1),
        "total_s": total_s, "residual": st["residual"],
        "tol": calc.opts.tol, "energy_ha": e_kernel,
        "energy_plain_jk_ha": e_plain, "anchor_ha": HF_ANCHOR_HA,
        "energy_minus_anchor_ha": e_kernel - HF_ANCHOR_HA,
        "launches": hf_launches, "launches_sad": hf_sad,
        "fock_builds": st["iterations"] + 1,
        "trace_dm_ovlp": trace_ds, "peak_device_bytes": peak_bytes,
        "guess": st.get("guess"), "sad_s": st.get("sad_s"),
        "iteration_profile": iteration_profile(calc.engine, theta,
                                               dm.contiguous(), smi_line),
    }
    emit({"main_path": main})
    if nao != 114:
        fail(f"nao = {nao}, expected 114")
    if not np.isfinite(e_kernel) or tuple(dm.shape) != (114, 114):
        fail("energy not finite or dm of the wrong shape")
    if not st["residual"] <= calc.opts.tol:
        fail(f"SCF residual {st['residual']:.3e} above tol {calc.opts.tol}")
    if main["guess"] != "sad":
        fail(f"HF started from {main['guess']!r}, expected 'sad'")
    check_launches("main_path", calc.engine, hf_launches,
                   main["iteration_profile"]
                   ["port_kernel_launches_per_iteration"], main["fock_builds"])
    if abs(trace_ds - 42.0) > 1e-8:
        fail(f"tr(D S) = {trace_ds!r}, expected 42")
    if abs(e_kernel - e_plain) > 1e-9:
        fail(f"kernel-path energy {e_kernel!r} vs plain-path {e_plain!r}")
    if abs(e_kernel - HF_ANCHOR_HA) > 1e-7:
        fail(f"energy {e_kernel!r} vs JAX-CPU anchor {HF_ANCHOR_HA!r}")

    # the ERI build scatters with index_add (atomics on the card); no index
    # repeats inside one call, so a second build has to give the same bits
    eri_k_again = calc._build_theta(calc._all_params())["eri_k"]
    eri_repeats = bool(torch.equal(eri_k_again, theta["eri_k"]))
    del eri_k_again
    emit({"eri_dense": {"bit_identical_on_rebuild": eri_repeats}})
    if not eri_repeats:
        fail("eri_dense gave different bits on a second build")

    # the eigensolver needs no polish on this card: residual of eigh at
    # nao = 114 on the orthogonalised Fock matrix and on the overlap
    X = theta["X"]
    fock = calc.engine.fock(dm, theta)     # one more launch, after the read
    eig = {}
    for name, A in (("fock_orth", X.T @ fock @ X), ("ovlp", theta["ovlp"])):
        A = 0.5 * (A + A.T)
        w, v = safe_eigh(A)
        eig[name] = float((A @ v - v * w[None, :]).abs().max())
        if not eig[name] <= 1e-10:
            fail(f"eigh residual on {name}: {eig[name]:.3e} > 1e-10")
    emit({"eigh": {"max_abs_residual": eig, "gate": 1e-10, "n": nao}})

    # the kernel on benzene's own eri_k: the seeded symmetric probe of the
    # JAX package's run-time check, and the converged density
    eri_k = theta["eri_k"]
    probe_np = np.random.RandomState(7).standard_normal((nao, nao))
    probe = torch.as_tensor(probe_np + probe_np.T, device=DEV)
    real_checks = [check_kernel(eri_k, probe, "benzene eri_k, probe"),
                   check_kernel(eri_k, dm.contiguous(),
                                "benzene eri_k, converged dm")]
    checks += real_checks

    # times at the main path's shape, in turns: plain, kernel, kernel, plain
    dmc = dm.contiguous()

    def run_kernel():
        ds_jk(eri_k, dmc)

    def run_plain():
        ds_jk_reference(eri_k, dmc)

    def run_library():
        torch.einsum("ijkl,kl->ij", eri_k, dmc)
        torch.einsum("iabl,al->ib", eri_k, dmc)

    reps = 20
    plain_a = time_ms(run_plain, reps)
    kern_a = time_ms(run_kernel, reps)
    kern_b = time_ms(run_kernel, reps)
    plain_b = time_ms(run_plain, reps)
    lib_ms = time_ms(run_library, reps)
    n = nao
    bytes_moved = 8 * (n ** 4 + n ** 2 + 2 * n ** 2)
    flops = 4 * n ** 4
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP64_FLOP_PER_S * 1e3
    kernel_ms = min(kern_a, kern_b)
    err_abs = max(max(c["trail_max_abs_err"], c["mid_max_abs_err"])
                  for c in real_checks)

    k1_hf = {"launches": launches, "ms_runs": [kern_a, kern_b],
             "plain_ms_runs": [plain_a, plain_b], "library_ms": lib_ms,
             "bytes_moved": bytes_moved, "flops": flops,
             "bound_ms": max(bound_bytes_ms, bound_ops_ms),
             "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
             else "operations", "max_abs_err": err_abs}
    del calc, theta, eri_k, dm, dmc, X, fock, k_ref, j_ref
    free_device()

    # 5. K2 and K3 against their plain versions on seeded tables
    xc_checks = []
    for ng, nao in ((100, 10), (700, 26), (78144, 114), (5000, 150)):
        ao, ag = xc_tables(ng, nao, seed=nao)
        rng = np.random.default_rng(ng)
        dm = rng.standard_normal((nao, nao))
        xc_checks.append(check_dens(ao, ag, torch.as_tensor(dm + dm.T,
                                                             device=DEV),
                                    f"tables({ng},{nao})"))
        # a non-symmetric dm as well: the kernel must not rely on symmetry
        xc_checks.append(check_dens(ao, ag, torch.as_tensor(dm, device=DEV),
                                    f"tables({ng},{nao}) nonsym dm"))
        vr = torch.as_tensor(rng.standard_normal(ng), device=DEV)
        vg = torch.as_tensor(rng.standard_normal((3, ng)), device=DEV)
        xc_checks.append(check_vxc(ao, ag, vr, vg, f"tables({ng},{nao})"))
        del ao, ag
    # K2 and K3 at a ragged small shape (ng nao odd: ao_grad's tables do not
    # start on 16 bytes) and at one that needs three panels of dm and of V
    # (nao > 128)
    for ng, nao in ((33, 7), (3000, 300)):
        ao, ag = xc_tables(ng, nao, seed=nao)
        rng = np.random.default_rng(ng)
        dm = rng.standard_normal((nao, nao))
        xc_checks.append(check_dens(ao, ag, torch.as_tensor(dm + dm.T,
                                                             device=DEV),
                                    f"tables({ng},{nao})"))
        xc_checks.append(check_dens(ao, ag, torch.as_tensor(dm, device=DEV),
                                    f"tables({ng},{nao}) nonsym dm"))
        vr = torch.as_tensor(rng.standard_normal(ng), device=DEV)
        vg = torch.as_tensor(rng.standard_normal((3, ng)), device=DEV)
        xc_checks.append(check_vxc(ao, ag, vr, vg, f"tables({ng},{nao})"))
        del ao, ag
    free_device()
    emit({"xc_kernel_checks": xc_checks, "gate_rel": GATE_REL})

    # 6. the main path of this slice: RKS-B3LYP on benzene/def2-SVP, grid 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mol = dq.Mol(benzene_desc(), basis="def2-svp", grid=2)
    calc = dq.KS(mol, xc="b3lyp")
    reset_counts()
    calc.run()
    ks_launches = path_counts()
    ks_sad = sad_counts()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    st = calc.stats
    theta = calc._theta
    grid = theta["grid"]
    xc = calc.engine.xc
    dm = calc.aodm().contiguous()
    e_kernel = float(calc.energy())
    ng = int(grid["dvol"].shape[0])
    # the plain path: the same converged dm through the plain versions of
    # all three kernels
    k_ref, j_ref = ds_jk_reference(theta["eri_k"], dm)
    rho, gdot = ds_dens_reference(grid["ao"], grid["ao_grad"], dm)
    dens = {"rho": rho, "grad": gdot}
    exc_plain = torch.sum(integrate._edens_at(xc, dens, False)
                          * grid["dvol"])
    e_plain = float(calc.engine.energy_from_parts(dm, j_ref, k_ref, theta,
                                                  exc=exc_plain))
    trace_ds = float(torch.einsum("ij,ji->", dm, theta["ovlp"]))
    nelec_grid = float(torch.sum(grid["dvol"] * rho))
    iters = st["iterations"]
    # one DIIS iteration of the main path under torch.profiler
    ks_profile = iteration_profile(calc.engine, theta, dm, smi_line)
    ks_per_it = ks_profile["port_kernel_launches_per_iteration"]
    main_ks = {
        "system": "benzene", "basis": "def2-svp", "method": "RKS-B3LYP",
        "grid": 2, "ngrid": ng, "nao": mol.meta.nao,
        "device": str(mol.device), "int1e_s": st["int1e_s"],
        "eri_dense_s": st["eri_s"], "grid_s": st["grid_s"],
        "scf_s": st["scf_s"], "iterations": iters,
        "s_per_iteration": (st["scf_s"] - st.get("sad_s", 0.0))
        / max(iters, 1),
        "energy_s": st["energy_s"], "total_s": total_s,
        "residual": st["residual"], "tol": calc.opts.tol,
        "energy_ha": e_kernel, "energy_plain_ha": e_plain,
        "anchor_ha": KS_ANCHOR_HA,
        "energy_minus_anchor_ha": e_kernel - KS_ANCHOR_HA,
        "launches": ks_launches, "launches_sad": ks_sad,
        "fock_builds": iters + 1,
        "trace_dm_ovlp": trace_ds, "sum_dvol_rho": nelec_grid,
        "sum_dvol_rho_jax": KS_NELEC_GRID_JAX,
        "peak_device_bytes": peak_bytes, "guess": st.get("guess"),
        "sad_s": st.get("sad_s"), "sad_elements": st.get("sad_elements"),
    }
    # the same SCF from the GWH Fock on the same theta: the iterations the
    # SAD start saves
    calc_gwh = dq.KS(mol, xc="b3lyp", opts=dq.SCFOptions(guess="gwh"))
    calc_gwh._theta = theta
    calc_gwh.run()
    main_ks.update(iterations_gwh=calc_gwh.stats["iterations"],
                   scf_s_gwh=calc_gwh.stats["scf_s"],
                   residual_gwh=calc_gwh.stats["residual"],
                   energy_gwh_ha=float(calc_gwh.energy()),
                   guess_gwh=calc_gwh.stats.get("guess"))
    del calc_gwh
    emit({"main_path_ks": main_ks})
    if main_ks["guess"] != "sad" or main_ks["guess_gwh"] != "gwh":
        fail(f"KS starts: {main_ks['guess']!r} and {main_ks['guess_gwh']!r},"
             " expected 'sad' and 'gwh'")
    if abs(main_ks["energy_gwh_ha"] - KS_ANCHOR_HA) > KS_GATE_HA:
        fail(f"KS energy from GWH {main_ks['energy_gwh_ha']!r} vs JAX-CPU "
             f"anchor {KS_ANCHOR_HA!r}")
    if mol.meta.nao != 114 or ng != 78144:
        fail(f"nao = {mol.meta.nao}, ng = {ng}; expected 114 and 78144")
    if not np.isfinite(e_kernel) or tuple(dm.shape) != (114, 114):
        fail("KS energy not finite or dm of the wrong shape")
    if not st["residual"] <= calc.opts.tol:
        fail(f"KS residual {st['residual']:.3e} above tol {calc.opts.tol}")
    if abs(e_kernel - KS_ANCHOR_HA) > KS_GATE_HA:
        fail(f"KS energy {e_kernel!r} vs JAX-CPU anchor {KS_ANCHOR_HA!r}")
    if abs(e_kernel - e_plain) > 1e-9:
        fail(f"KS kernel-path energy {e_kernel!r} vs plain-path {e_plain!r}")
    if abs(trace_ds - NELEC) > 1e-8:
        fail(f"KS tr(D S) = {trace_ds!r}, expected {NELEC}")
    if abs(nelec_grid - KS_NELEC_GRID_JAX) > 1e-8 or \
            abs(nelec_grid - NELEC) > 1e-3:
        fail(f"sum dvol rho = {nelec_grid!r}, expected "
             f"{KS_NELEC_GRID_JAX!r} (JAX-CPU, same grid)")
    check_launches("main_path_ks", calc.engine, ks_launches, ks_per_it,
                   iters + 1)

    # 7. K2/K3 on benzene's grid tables: the converged dm and the real
    # pointwise potentials vrho, vgrad at it
    ao, ag = grid["ao"], grid["ao_grad"]
    _, vbar = integrate._pointwise_adjoints(xc, dens, grid["dvol"], False,
                                            None)
    vr, vg = vbar["rho"].contiguous(), vbar["grad"].contiguous()
    real_xc = [check_dens(ao, ag, dm, "benzene grid, converged dm"),
               check_vxc(ao, ag, vr, vg, "benzene grid, real vrho/vgrad")]
    xc_checks += real_xc
    emit({"ks_kernel_checks": real_xc})

    # 8. times at the main path's shape, in turns; library_ms is PyTorch's
    # own way to compute the same function, timed here and used nowhere
    def dens_library():
        c = ao @ dm.T
        (c * ao).sum(-1)
        2.0 * (ag * c).sum(-1)

    def vxc_library():
        w = vr[:, None] * ao + 2.0 * torch.einsum("dg,dgi->gi", vg, ag)
        w.T @ ao

    eri_k = theta["eri_k"]
    k1_ms, k1_plain = time_turns(lambda: ds_jk(eri_k, dm),
                                 lambda: ds_jk_reference(eri_k, dm))
    k2_ms, k2_plain = time_turns(lambda: ds_dens_gga(ao, ag, dm),
                                 lambda: ds_dens_reference(ao, ag, dm))
    k3_ms, k3_plain = time_turns(lambda: ds_vxc_gga(ao, ag, vr, vg),
                                 lambda: ds_vxc_reference(ao, ag, vr, vg))
    k2_lib = time_ms(dens_library, 20)
    k3_lib = time_ms(vxc_library, 20)
    nao = mol.meta.nao
    k2_bytes = 8 * (4 * ng * nao + nao * nao + 4 * ng)
    # one GEMM (C = phi dm^T) and four row dots: the function's own work
    k2_flops = 2 * ng * nao * nao + 8 * ng * nao
    k3_bytes = 8 * (4 * ng * nao + 4 * ng + nao * nao)
    k3_flops = 2 * ng * nao * nao + 8 * ng * nao
    k2_bound, k2_by = bound(k2_bytes, k2_flops)
    k3_bound, k3_by = bound(k3_bytes, k3_flops)
    # the launch plans the wrappers chose for K2, K3 and K1 at these shapes
    # (derived from the shapes and the card, not measured)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"ds_dens_gga_plan": hopper_xc.dens_plan(ng, nao, sms)})
    emit({"ds_vxc_gga_plan": hopper_xc.vxc_plan(ng, nao, sms)})
    emit({"ds_jk_plan": {"n": nao, **hopper_jk.jk_plan(nao, sms)}})
    # each kernel's time times its launches in one iteration (measured)
    per_it = {"ds_jk": min(k1_ms) * ks_per_it["ds_jk"],
              "ds_dens_gga": min(k2_ms) * ks_per_it["ds_dens_gga"],
              "ds_vxc_gga": min(k3_ms) * ks_per_it["ds_vxc_gga"]}
    emit({"ks_iteration_ms": {"s_per_iteration_ms":
                              1e3 * main_ks["s_per_iteration"],
                              "launches_per_iteration": ks_per_it,
                              "kernel_ms_per_iteration": per_it}})
    emit({"ks_iteration_profile": ks_profile})
    # the dense monomer's quadrupole, for the dimer phases
    theta_zz = quadrupole_zz(calc)
    # the variational solver on the main path's theta, against its DIIS
    var_rec = variational_benzene(smi_line, mol, theta, e_kernel)
    # purification against eigh on the main path's converged Fock matrix
    purify_benzene(calc, smi_line)
    free_device()

    # 9. the blocked route on the main path's molecule, held against K1 on
    # this eri_k
    blocked_rec = blocked_b3lyp(smi_line, main_ks, eri_k)
    free_device()

    # 10. the kernels' backward against autograd of their plain versions,
    # then the forces of the main path by implicit differentiation, on the
    # dense and the blocked route; the streamed route
    kernel_backward_checks(theta["eri_k"])
    del calc, theta, grid, eri_k, ao, ag
    free_device()
    force_rec = forces(smi_line)
    free_device()
    blocked_force_rec = blocked_forces(smi_line, force_rec)
    free_device()
    stream_rec = stream_b3lyp(smi_line, main_ks)
    free_device()

    # 10b. properties: second and third derivatives of the energy through
    # the SCF (Hessians, polarizabilities, IR, Raman) on a small molecule
    # against CCCBDB and the JAX package, through K1-K3 against central
    # differences, and on the main path's molecule
    props_hf = props_h2o_hf(smi_line)
    free_device()
    props_ks = props_h2o_b3lyp(smi_line)
    free_device()
    props_bz = props_benzene(smi_line)
    free_device()

    # 11. the breadth of the dense route: range separation, a meta-GGA, a
    # neural functional with its parameter gradient, and nao past 128 (then
    # the same molecule on the blocked route)
    cam_rec, lr_check = cam_b3lyp(smi_line)
    checks.append(lr_check)
    free_device()
    mgga_rec = meta_gga(smi_line)
    free_device()
    nn_rec = nn_xc(smi_line)
    free_device()
    # the batch axis: 4 geometries of benzene through one batched SCF (one
    # launch of each kernel per Fock build), the NN loss and its gradient;
    # the on-disk theta cache
    batch_rec = batch_nnxc(smi_line)
    free_device()
    cache_benzene(smi_line)
    free_device()
    vitc_rec = vitamin_c(smi_line)
    free_device()
    blocked_vitc_rec = blocked_vitamin_c(smi_line, vitc_rec)
    free_device()

    # 12. density fitting: RI-J/RI-K in place of K1, the long-range fit of
    # range separation, forces, the reference's vitamin C workload, a
    # molecule past the dense limit, and a polarized case
    df_rec = df_b3lyp(smi_line)
    free_device()
    df_cam_rec = df_cam_b3lyp(smi_line)
    free_device()
    df_force_rec = df_forces(smi_line)
    free_device()
    df_vitc_rec = df_vitamin_c(smi_line, vitc_rec)
    free_device()
    dimer_rec, dimer_checks = df_beyond_dense(smi_line, df_rec["energy_ha"],
                                              df_rec["theta_zz"])
    xc_checks += dimer_checks
    free_device()
    o2_rec = df_uks_o2(smi_line)
    free_device()
    # 13. the dimer without densityfit(): the blocked route
    bbd_rec, bbd_checks = blocked_beyond_dense(
        smi_line, main_ks["energy_ha"], theta_zz, dimer_rec["energy_ha"])
    xc_checks += bbd_checks
    free_device()
    # 14. periodic cells at the Gamma point: the slice's main path at full
    # width (UKS-PBE of H27, K2 and K3 once per spin per Fock build), the
    # routes of H8 against JAX-CPU anchors, and H8's forces
    h27_rec = pbc_h27_pbe(smi_line)
    xc_checks += h27_rec["kernel_checks"]
    free_device()
    h8_recs = pbc_h8(smi_line)
    free_device()
    pbc_force_rec = pbc_h8_forces(smi_line)
    free_device()
    # 15. periodic cells with k-points: the slice's main path at full width
    # (RKS-PBE of H8 on the 3x3x3 mesh, K2 and K3 once per k-point per Fock
    # build on the embedded Bloch tables), Bloch's theorem against the
    # Gamma path, every route on the two-point mesh against JAX-CPU
    # anchors, a hybrid on the 2x2x2 mesh, and forces
    k_main = pbc_k_h8_pbe(smi_line)
    xc_checks += k_main["kernel_checks"]
    free_device()
    k_bloch = pbc_k_bloch(smi_line)
    free_device()
    k3_recs = pbc_k_h8_3mesh(smi_line)
    free_device()
    k222 = pbc_k_h8_pbe0_222(smi_line)
    free_device()
    k_force = pbc_k_forces(smi_line)
    free_device()
    # 16. a batch on every route: B = 2 k-point cells at the k-point main
    # path's width (K2/K3 27 times per batched Fock build, on strided views
    # of the members' tables), four H8 cells at Gamma (pair transforms and
    # the periodic fit, and the position gradient of their sum), two
    # benzene geometries on the blocked and streamed routes and by the
    # variational solver
    batch_k = batch_kpbc(smi_line, k_main)
    free_device()
    batch_g = batch_pbc_gamma(smi_line)
    free_device()
    batch_blk = batch_blocked(smi_line, blocked_rec)
    free_device()
    batch_str = batch_stream(smi_line, stream_rec)
    free_device()
    batch_var = batch_variational(smi_line, var_rec)
    free_device()
    by_path = {"main_path_hf": hf_launches, "main_path_ks": ks_launches,
               "forces_gradient": force_rec["launches_in_gradient"],
               "cam_b3lyp": cam_rec["launches"],
               "meta_gga": mgga_rec["launches"], "nn_xc": nn_rec["launches"],
               "nn_xc_gradient": nn_rec["launches_in_gradient"],
               "batch_nnxc": batch_rec["launches"],
               "batch_nnxc_gradient": batch_rec["launches_in_gradient"],
               "vitamin_c": vitc_rec["launches"],
               "df_b3lyp": df_rec["launches"],
               "df_cam_b3lyp": df_cam_rec["launches"],
               "df_forces_gradient": df_force_rec["launches_in_gradient"],
               "df_vitamin_c": df_vitc_rec["launches"],
               "df_beyond_dense": dimer_rec["launches"],
               "df_uks_o2": o2_rec["launches"],
               "blocked_b3lyp": blocked_rec["launches"],
               "blocked_forces_gradient":
                   blocked_force_rec["launches_in_gradient"],
               "stream_b3lyp": stream_rec["launches"],
               "blocked_vitamin_c": blocked_vitc_rec["launches"],
               "blocked_beyond_dense": bbd_rec["launches"],
               "pbc_h27_pbe": h27_rec["launches"],
               **{f"pbc_h8_hf[{k}]": r["launches"]
                  for k, r in h8_recs["pbc_h8_hf"].items()},
               **{ph: r["launches"] for ph, r in h8_recs.items()
                  if ph != "pbc_h8_hf"},
               **{f"pbc_h8_forces_gradient[{k}]": r["launches_in_gradient"]
                  for k, r in pbc_force_rec.items()},
               "pbc_k_h8_pbe": k_main["launches"],
               **{f"pbc_k_bloch[{k}_3x1x1]": r["kmesh"]["launches"]
                  for k, r in k_bloch.items()},
               **{f"pbc_k_bloch[{k}_h24]": r["h24"]["launches"]
                  for k, r in k_bloch.items()},
               **{ph: r["launches"] for ph, r in k3_recs.items()},
               "pbc_k_h8_pbe0_222": k222["launches"],
               **{f"pbc_k_forces_gradient[{k}]": r["launches_in_gradient"]
                  for k, r in k_force.items()},
               "batch_kpbc": batch_k["launches"],
               "batch_pbc_gamma[pbe]": batch_g["pbe"]["launches"],
               "batch_pbc_gamma[pbe0_gdf]": batch_g["pbe0_gdf"]["launches"],
               "batch_blocked": batch_blk["launches"],
               "batch_stream": batch_str["launches"],
               "batch_variational": batch_var["launches"]}

    sad_by_path = {"main_path_hf": hf_sad, "main_path_ks": ks_sad,
                   "cam_b3lyp": cam_rec["launches_sad"],
                   "meta_gga": mgga_rec["launches_sad"],
                   "nn_xc": nn_rec["launches_sad"],
                   "batch_nnxc": batch_rec["launches_sad"],
                   "vitamin_c": vitc_rec["launches_sad"],
                   "df_b3lyp": df_rec["launches_sad"],
                   "df_cam_b3lyp": df_cam_rec["launches_sad"],
                   "df_vitamin_c": df_vitc_rec["launches_sad"],
                   "df_beyond_dense": dimer_rec["launches_sad"],
                   "df_uks_o2": o2_rec["launches_sad"],
                   "blocked_b3lyp": blocked_rec["launches_sad"],
                   "stream_b3lyp": stream_rec["launches_sad"],
                   "blocked_vitamin_c": blocked_vitc_rec["launches_sad"],
                   "blocked_beyond_dense": bbd_rec["launches_sad"],
                   "batch_blocked": batch_blk["launches_sad"],
                   "batch_stream": batch_str["launches_sad"],
                   "batch_variational": batch_var["launches_sad"]}

    def launches_of(name, paths=by_path):
        return {path: c.get(name, 0) for path, c in paths.items()}

    batch_recs = {"batch_kpbc": batch_k,
                  "batch_pbc_gamma[pbe]": batch_g["pbe"],
                  "batch_pbc_gamma[pbe0_gdf]": batch_g["pbe0_gdf"],
                  "batch_blocked": batch_blk, "batch_stream": batch_str,
                  "batch_variational": batch_var}

    def batch_routes(name):
        """Launches per batched Fock build on each batch-route path (per
        batched energy for the variational solver's)."""
        out = {path: r["launches_per_fock_build"][name]
               for path, r in batch_recs.items()}
        out["batch_variational_per_evaluation"] = \
            batch_var["launches_per_evaluation"][name]
        return out

    # launches inside the property calls: second-order (Hessians,
    # polarizabilities, IR's mixed derivative, the orbital Hessian), third
    # order (Raman's dalpha/dR), and the variational solver's
    prop_recs = {"props_h2o_hf": props_hf, "props_h2o_b3lyp": props_ks,
                 "props_benzene": props_bz}
    second = {"props_h2o_hf": ("hessian_pos", "ir_spectrum",
                               "polarizability", "lowest_eival_orb_hessian"),
              "props_h2o_b3lyp": ("hessian_pos", "polarizability"),
              "props_benzene": ("polarizability", "polarizability_hf")}
    third = {"props_h2o_hf": ("raman_spectrum",),
             "props_h2o_b3lyp": ("dalpha_dpos",)}

    def prop_launches(name):
        def table(calls):
            return {f"{ph}.{c}": prop_recs[ph]["calls"][c][name]
                    for ph, cs in calls.items() for c in cs}
        var = {f"props_h2o_hf.variational_{op}":
               props_hf["calls"][f"variational_{op}"][name]
               for op in ("matexp", "qr", "ov")}
        var["variational_benzene"] = var_rec["launches"][name]
        return {"launches_second_order": table(second),
                "launches_third_order": table(third),
                "launches_variational": var}

    # 14. a small molecule against its published energy
    qc = dq.HF(dq.Mol("H -0.5 0 0; H 0.5 0 0", basis="3-21G")).run()
    e_h2 = float(qc.energy())
    emit({"small": {"system": "H2", "basis": "3-21G", "energy_ha": e_h2,
                    "anchor_ha": H2_ANCHOR_HA, "tol_ha": 1e-6,
                    "iterations": qc.stats["iterations"]}})
    if abs(e_h2 - H2_ANCHOR_HA) > 1e-6:
        fail(f"H2/3-21G energy {e_h2!r} vs {H2_ANCHOR_HA}")

    def xc_err(checks):
        return max(v for c in checks for k, v in c.items()
                   if k.endswith("_max_abs_err"))

    dens_checks = [c for c in xc_checks if "rho_max_abs_err" in c]
    vxc_checks = [c for c in xc_checks if "v_max_abs_err" in c]
    emit({"kernels": [{
        "name": "ds_jk", "route": "cuda",
        "source": "dqc_tpu_torch/csrc/ds_jk.cu",
        "replaces": "dqc_tpu/ops/pallas_jk.py:211",
        "launches": ks_launches["ds_jk"],
        "launches_in_gradient": force_rec["launches_in_gradient"]["ds_jk"],
        "max_abs_err": k1_hf["max_abs_err"],
        "ms": min(k1_ms), "plain_ms": min(k1_plain),
        "bound_ms": k1_hf["bound_ms"], "bound_by": k1_hf["bound_by"],
        "library_ms": k1_hf["library_ms"],
        "launches_hf_path": k1_hf["launches"],
        "launches_by_path": launches_of("ds_jk"),
        "launches_sad_by_path": launches_of("ds_jk", sad_by_path),
        "launches_eri_lr": cam_rec["launches"]["ds_jk_eri_lr"],
        **prop_launches("ds_jk"),
        "n": n, "bytes_moved": k1_hf["bytes_moved"], "flops": k1_hf["flops"],
        "ms_runs": k1_ms, "plain_ms_runs": k1_plain,
        "ms_runs_hf_phase": k1_hf["ms_runs"],
        "plain_ms_runs_hf_phase": k1_hf["plain_ms_runs"],
        "gate_rel": GATE_REL, "checks": checks,
        "gbytes_per_s": k1_hf["bytes_moved"] / (min(k1_ms) * 1e-3) / 1e9,
        "launches_per_batched_fock_build": batch_routes("ds_jk"),
        "batched": dict(batch_rec["kernels"]["ds_jk"],
                        launches_per_fock_build=batch_rec[
                            "launches_per_fock_build"]["ds_jk"],
                        max_rel_err_checks=max(
                            c["max_rel_err"] for c in batch_rec[
                                "kernel_checks"] if c["kernel"] == "ds_jk")),
        "card": smi_line,
    }, {
        "name": "ds_dens_gga", "route": "cuda",
        "source": "dqc_tpu_torch/csrc/ds_dens_gga.cu",
        "replaces": "dqc_tpu/ops/pallas_xc.py:254",
        "launches": ks_launches["ds_dens_gga"],
        "launches_in_gradient":
            force_rec["launches_in_gradient"]["ds_dens_gga"],
        "launches_by_path": launches_of("ds_dens_gga"),
        "launches_sad_by_path": launches_of("ds_dens_gga", sad_by_path),
        **prop_launches("ds_dens_gga"),
        "max_abs_err": xc_err(real_xc[:1]),
        "ms": min(k2_ms), "plain_ms": min(k2_plain),
        "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib,
        "ng": ng, "nao": nao, "bytes_moved": k2_bytes, "flops": k2_flops,
        "ms_runs": k2_ms, "plain_ms_runs": k2_plain,
        "max_abs_err_all_cases": xc_err(dens_checks),
        "max_rel_err_all_cases": max(max(c["rho_rel_err"], c["gdot_rel_err"])
                                     for c in dens_checks),
        "gate_rel": GATE_REL,
        "gbytes_per_s": k2_bytes / (min(k2_ms) * 1e-3) / 1e9,
        "gflop_per_s": k2_flops / (min(k2_ms) * 1e-3) / 1e9,
        "pbc_h27": h27_rec["kernels"]["ds_dens_gga"],
        "pbc_k_h8_embedded": k_main["kernels"]["ds_dens_gga"],
        "strided_kpoint_view": batch_k["kernels_strided"]["ds_dens_gga"],
        "launches_per_batched_fock_build": batch_routes("ds_dens_gga"),
        "batched": dict(batch_rec["kernels"]["ds_dens_gga"],
                        launches_per_fock_build=batch_rec[
                            "launches_per_fock_build"]["ds_dens_gga"],
                        max_rel_err_checks=max(
                            c["max_rel_err"] for c in batch_rec[
                                "kernel_checks"] if c["kernel"] == "ds_dens_gga")),
        "card": smi_line,
    }, {
        "name": "ds_vxc_gga", "route": "cuda",
        "source": "dqc_tpu_torch/csrc/ds_vxc_gga.cu",
        "replaces": "dqc_tpu/ops/pallas_xc.py:348",
        "launches": ks_launches["ds_vxc_gga"],
        "launches_in_gradient":
            force_rec["launches_in_gradient"]["ds_vxc_gga"],
        "launches_by_path": launches_of("ds_vxc_gga"),
        "launches_sad_by_path": launches_of("ds_vxc_gga", sad_by_path),
        **prop_launches("ds_vxc_gga"),
        "max_abs_err": xc_err(real_xc[1:]),
        "ms": min(k3_ms), "plain_ms": min(k3_plain),
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": k3_lib,
        "ng": ng, "nao": nao, "bytes_moved": k3_bytes, "flops": k3_flops,
        "ms_runs": k3_ms, "plain_ms_runs": k3_plain,
        "max_abs_err_all_cases": xc_err(vxc_checks),
        "max_rel_err_all_cases": max(c["v_rel_err"] for c in vxc_checks),
        "gate_rel": GATE_REL,
        "gbytes_per_s": k3_bytes / (min(k3_ms) * 1e-3) / 1e9,
        "gflop_per_s": k3_flops / (min(k3_ms) * 1e-3) / 1e9,
        "resources": ptxas_summary(builds["ds_vxc_gga"]["log"]),
        "pbc_h27": h27_rec["kernels"]["ds_vxc_gga"],
        "pbc_k_h8_embedded": k_main["kernels"]["ds_vxc_gga"],
        "strided_kpoint_view": batch_k["kernels_strided"]["ds_vxc_gga"],
        "launches_per_batched_fock_build": batch_routes("ds_vxc_gga"),
        "batched": dict(batch_rec["kernels"]["ds_vxc_gga"],
                        launches_per_fock_build=batch_rec[
                            "launches_per_fock_build"]["ds_vxc_gga"],
                        max_rel_err_checks=max(
                            c["max_rel_err"] for c in batch_rec[
                                "kernel_checks"] if c["kernel"] == "ds_vxc_gga")),
        "card": smi_line,
    }], "seconds": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
