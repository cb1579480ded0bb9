"""JAX-CPU anchors of chip_smoke.py's benzene phases; a report, not a test
(pytest does not collect it):

    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py camb3lyp scan nnxc

For each functional named on the command line, one JSON line: the energy
of dqc_tpu.KS(benzene/def2-SVP, grid=2, xc, SCFOptions(mixed=False)) (the
geometry of chip_smoke.benzene_desc), the seconds it took, the achieved
DIIS residual and the tolerance. Takes minutes per functional on one core.
"nnxc" is the family-2 neural functional of chip_smoke.py's nn_xc phase
(nn_params_np, nn_edens: the same seed, parameters and formula), as a
CustomXC of the JAX package.

The JAX package refuses range separation on its blocked J/K route, which it
takes at this size (its dense limit is 600 MiB); for a functional with
long-range exchange the script raises that limit for the run
(dqc_tpu.scf.qccalc.DENSE_ERI_BYTES_LIMIT), so the anchor comes from the
dense route, the port's route.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import dqc_tpu  # noqa: E402
from dqc_tpu.scf import qccalc as jqccalc  # noqa: E402
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions  # noqa: E402
from dqc_tpu.xc import get_xc  # noqa: E402
from dqc_tpu.xc.custom import CustomXC  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_enable_x64", True)

BOHR = 0.529177210903   # chip_smoke.ANGSTROM_TO_BOHR = 1 / BOHR


def benzene_desc():
    rcc, rch = 1.39 / BOHR, (1.39 + 1.09) / BOHR
    atoms = []
    for i in range(6):
        a = np.pi / 3 * i
        atoms.append(f"C {rcc*np.cos(a):.10f} {rcc*np.sin(a):.10f} 0.0")
        atoms.append(f"H {rch*np.cos(a):.10f} {rch*np.sin(a):.10f} 0.0")
    return "; ".join(atoms)


NN_SEED = 8


def nn_params_np():
    """The seeded parameters of chip_smoke.nn_params_np."""
    rng = np.random.default_rng(NN_SEED)
    return {"w1": 0.5 * rng.standard_normal(8),
            "ws": 0.5 * rng.standard_normal(8),
            "b1": 0.1 * rng.standard_normal(8),
            "w2": 0.5 * rng.standard_normal((8, 1)),
            "b2": 0.1 * rng.standard_normal(1)}


def nn_edens(p, d):
    """examples/04_neural_xc.py's functional with s = |grad rho|/rho^(4/3)
    as a second input (chip_smoke.nn_edens in torch)."""
    rho, sigma = d["rho"], d["sigma"]
    n43 = rho ** (4.0 / 3.0)
    x = rho ** (1.0 / 3.0)
    s = jnp.sqrt(jnp.maximum(sigma, 1e-40)) / n43
    h = jnp.tanh(x[..., None] * p["w1"] + s[..., None] * p["ws"] + p["b1"])
    f = 1.0 + 0.2 * jnp.tanh(h @ p["w2"] + p["b2"])[..., 0]
    c = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)
    return -c * n43 * f


def resolve(name):
    if name == "nnxc":
        p = {k: jnp.asarray(v) for k, v in nn_params_np().items()}
        return CustomXC(nn_edens, p, family=2, key="nnxc")
    return name


def main(names):
    for name in names:
        xc = resolve(name)
        t0 = time.perf_counter()
        opts = JOptions(mixed=False)
        dense_limit = jqccalc.DENSE_ERI_BYTES_LIMIT
        if get_xc(xc).exx_lr:
            jqccalc.DENSE_ERI_BYTES_LIMIT = 4 * 1024 ** 3
        mol = dqc_tpu.Mol(benzene_desc(), basis="def2-svp", grid=2)
        qc = dqc_tpu.KS(mol, xc=xc, opts=opts).run()
        e = float(qc.energy())
        jqccalc.DENSE_ERI_BYTES_LIMIT = dense_limit
        print(json.dumps({
            "system": "benzene", "basis": "def2-svp", "grid": 2, "xc": name,
            "energy_ha": e, "seconds": time.perf_counter() - t0,
            "residual": getattr(qc, "_achieved_err", None),
            "tol": opts.tol, "jk_route": "dense" if "eri" in qc._theta
            else "blocked", "backend": jax.default_backend()}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["camb3lyp", "scan", "nnxc"])
