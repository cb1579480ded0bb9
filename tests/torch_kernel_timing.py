"""Times K1-K3 on one NVIDIA GPU at the main path's shapes (benzene/def2-SVP:
nao 114, 78,144 grid points) on seeded tensors, unbatched, and prints one
line: the tree's directory and the best of three timings of each kernel.

Run from the root of a checkout, so that two trees can be compared in one
run on one card (the script itself may live in the other tree):

    (cd parent_tree && python /path/to/tests/torch_kernel_timing.py)
    python tests/torch_kernel_timing.py

It uses chip_smoke.py's generators and timer, and imports nothing of JAX.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.getcwd())

import numpy as np   # noqa: E402
import torch         # noqa: E402

import chip_smoke as cs                                    # noqa: E402
from dqc_tpu_torch.ops import _nvcc, hopper_jk, hopper_xc  # noqa: E402


def main():
    names = ("ds_jk", "ds_dens_gga", "ds_vxc_gga")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(lambda n: _nvcc.build(n, force=True), names))
    n, ng = 114, 78144
    T = cs.card_like(n, seed=3)
    rng = np.random.default_rng(1)
    d = rng.standard_normal((n, n))
    dm = torch.as_tensor(d + d.T, device=cs.DEV)
    ao, ag = cs.xc_tables(ng, n, seed=5)
    vr = torch.as_tensor(rng.standard_normal(ng), device=cs.DEV)
    vg = torch.as_tensor(rng.standard_normal((3, ng)), device=cs.DEV)
    runs = [[cs.time_ms(lambda: hopper_jk.ds_jk(T, dm), 30),
             cs.time_ms(lambda: hopper_xc.ds_dens_gga(ao, ag, dm), 40),
             cs.time_ms(lambda: hopper_xc.ds_vxc_gga(ao, ag, vr, vg), 40)]
            for _ in range(3)]
    best = [min(r[i] for r in runs) for i in range(3)]
    print(os.path.basename(os.getcwd()), "K1 K2 K3 best ms",
          [round(x, 4) for x in best], "runs",
          [[round(x, 4) for x in r] for r in runs], flush=True)


if __name__ == "__main__":
    main()
