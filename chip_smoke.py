#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel of the port from the sources in this
checkout, holds it against its plain PyTorch version on the card, drives the
port's main path — restricted Hartree-Fock on benzene/def2-SVP (nao = 114)
through `Mol`, `HF`, `SCF_QCCalc.run` — and checks what comes out. Any failed
check or exception ends the run with a non-zero exit code. Without a CUDA
device it fails at once and prints no result.

One JSON object per line: `device`, the card's name and power limit as
nvidia-smi prints them, `build`, `kernel_checks`, `main_path`, `eri_dense`,
`eigh`, `small`, `kernels`, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports the port only; nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; "
                     "this script needs one CUDA device\n")
    sys.exit(2)

import dqc_tpu_torch as dq                                    # noqa: E402
from dqc_tpu_torch.ops import hopper_jk                       # noqa: E402
from dqc_tpu_torch.ops.hopper_jk import ds_jk, ds_jk_reference  # noqa: E402
from dqc_tpu_torch.scf.eigh import safe_eigh                  # noqa: E402

DEV = torch.device("cuda", 0)

# data-sheet peaks of the H100 SXM: device memory rate, and the float64
# rate of the tensor cores (the vector units do half of it); the bound uses
# the larger rate so that it stays a lower bound on the time
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12

GATE_REL = 1e-10          # kernel against its plain version, J and K
# JAX-CPU value of dqc_tpu.HF(benzene/def2-svp, SCFOptions(mixed=False)),
# same geometry, converged to a residual of 9e-10 (float64, x86-64 host)
HF_ANCHOR_HA = -230.5357956254473
H2_ANCHOR_HA = -1.07195346   # RHF H2/3-21G, d = 1.0 a0 (PySCF)

ANGSTROM_TO_BOHR = 1.0 / 0.529177210903


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

    # 2. build
    b = hopper_jk.build(force=True)
    emit({"build": {"source": "dqc_tpu_torch/csrc/ds_jk.cu",
                    "seconds": b["seconds"], "ptxas": b["log"]}})

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
    torch.cuda.empty_cache()
    emit({"kernel_checks": checks, "gate_rel": GATE_REL})

    # 4. the main path: HF on benzene/def2-SVP
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mol = dq.Mol(benzene_desc(), basis="def2-svp")
    calc = dq.HF(mol)
    ds_jk.launches = 0
    calc.run()
    launches = ds_jk.launches
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
        "s_per_iteration": st["scf_s"] / max(st["iterations"], 1),
        "total_s": total_s, "residual": st["residual"],
        "tol": calc.opts.tol, "energy_ha": e_kernel,
        "energy_plain_jk_ha": e_plain, "anchor_ha": HF_ANCHOR_HA,
        "energy_minus_anchor_ha": e_kernel - HF_ANCHOR_HA,
        "ds_jk_launches": launches, "fock_builds": st["iterations"] + 1,
        "trace_dm_ovlp": trace_ds, "peak_device_bytes": peak_bytes,
        "guess": "gwh",
    }
    emit({"main_path": main})
    if nao != 114:
        fail(f"nao = {nao}, expected 114")
    if not np.isfinite(e_kernel) or tuple(dm.shape) != (114, 114):
        fail("energy not finite or dm of the wrong shape")
    if not st["residual"] <= calc.opts.tol:
        fail(f"SCF residual {st['residual']:.3e} above tol {calc.opts.tol}")
    if not (launches > 0 and launches >= st["iterations"] + 1):
        fail(f"ds_jk launched {launches} times for "
             f"{st['iterations'] + 1} Fock builds")
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

    # 5. a small molecule against its published energy
    qc = dq.HF(dq.Mol("H -0.5 0 0; H 0.5 0 0", basis="3-21G")).run()
    e_h2 = float(qc.energy())
    emit({"small": {"system": "H2", "basis": "3-21G", "energy_ha": e_h2,
                    "anchor_ha": H2_ANCHOR_HA, "tol_ha": 1e-6,
                    "iterations": qc.stats["iterations"]}})
    if abs(e_h2 - H2_ANCHOR_HA) > 1e-6:
        fail(f"H2/3-21G energy {e_h2!r} vs {H2_ANCHOR_HA}")

    emit({"kernels": [{
        "name": "ds_jk", "route": "cuda",
        "source": "dqc_tpu_torch/csrc/ds_jk.cu",
        "replaces": "dqc_tpu/ops/pallas_jk.py:211",
        "launches": launches,
        "max_abs_err": err_abs,
        "ms": kernel_ms, "plain_ms": min(plain_a, plain_b),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
        else "operations",
        "library_ms": lib_ms,
        "n": n, "bytes_moved": bytes_moved, "flops": flops,
        "ms_runs": [kern_a, kern_b], "plain_ms_runs": [plain_a, plain_b],
        "gate_rel": GATE_REL, "checks": checks,
        "gbytes_per_s": bytes_moved / (kernel_ms * 1e-3) / 1e9,
        "card": smi_line,
    }], "seconds": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
