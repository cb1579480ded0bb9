"""Periodic cells at k-points (counterpart of dqc_tpu/scf/kpbc.py).

The k-resolved SCF of a Sol with a k-mesh: restricted or unrestricted,
LDA, GGA and meta-GGA, hybrid and range-separated exact exchange with the
Born-von-Karman Madelung term, and the Gaussian fit of the Coulomb term.
All electrostatics are assembled in G space from the Bloch pair transforms
Q^k_ij(G) = int_cell phi^k_i(r)^* phi^k_j(r) e^{-iG.r} dr
(ops/pbcft.pbc_pair_ft_k):

  rho(G) = sum_k w_k tr(D^k Q^k(G)),       J^k = sum_G w_G rho(G) Q^k(-G),
  Vne^k  = sum_G w_G n_nuc(G) Q^k(-G),     E_J = 1/2 sum_G w_G |rho(G)|^2.

Q^k_ij(-G) = conj(Q^k_ji(G)) exactly (the translation sum runs over T and
-T alike), so J and Vne are the transposes of sum_G a(G) conj(Q^k(G)):
GEMVs over the stored transforms, where the JAX package gathers Q at the
index of -G (its _neg_g_index), a copy of the whole tensor per Fock build.

XC through the grid kernels K2 and K3 on an exact real embedding of the
Bloch tables. With D^k = P + iQ and phi^k = a + ib, u = [a; b]
(ops/aoeval.eval_ao_pbc_k stores [Re | Im] tables of width 2 nao):
  - density: Re sum_ij D_ij x_i conj(y_j) = x_u^T M y_u with the real
    M = [[P, Q], [-Q, P]] (symmetric for a Hermitian D), so rho, grad rho,
    and the meta-GGA's lapl and tau of sum_k w_k D^k are the molecular
    formulas on (u, M^k = w_k M): K2 once per k and spin, summed;
  - potential: from the raw W = sum_g WT u^T of the same tables (K3 once
    per k and spin), V^k = (W_aa + W_bb) + i (W_ab - W_ba), then its
    Hermitian part.
Both identities hold for any D (not only a Hermitian one), term by term;
the JAX package's complex einsums (_dens_plain, _assemble_plain) are the
plain version they are held against. The lapl and tau terms stay plain
torch, as on the Gamma path.

State: the SCF carries the complex D^k (nk, nao, nao) ((2, nk, nao, nao)
polarized) and its Fock matrices as real tensors of stacked (re, im) on a
leading axis (split/join), so DIIS, GMRES and the implicit derivative to
any order keep their real algebra, as the JAX package's re/im-split
pytree does. Every public method of KPBCEngine takes and returns that
form; aodm() gives the complex D^k back.

Everything downstream of params is torch, so the energy is differentiable
in the atom positions and the basis parameters. HF at k-points is this
engine with the pure exchange functional "hf" (no grid is built for it:
its semilocal energy is zero).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.aoeval import eval_ao_pbc_k
from ..ops.pbc import estimate_rcut, pbc_kinetic, pbc_overlap
from ..ops.pbcft import (_blocked, _g_block, coulomb_gweights, eval_ao_ft,
                         gcut_estimate, pbc_pair_ft_k, pbc_pair_plan_ordered)
from ..system.lattice import Lattice, ewald_energy
from ..utils.config import DTYPE, config
from ..utils.datastruct import stack_members, tree_member
from ..xc.base import HFExchangeXC
from ..xc.integrate import (_deriv_of_family, _edens_at, _pointwise_adjoints,
                            _vxc_assemble, density_from_tables)
from .df import pinv_sqrt
from .eigh import eigh_density
from .orth import LARGE, orthogonalizer
from .pbc import (AO_PRECISION, AO_PT_CHUNK, CORE_PRECISION,
                  GDF_METRIC_CUTOFF, _sync, pbc_grid_points)


def split(z, batched: bool = False):
    """Complex tensor -> real tensor of stacked (re, im) on axis 0 (on axis
    1 for a batch, whose axis 0 is the member: x[m] is member m's state)."""
    return torch.stack([z.real, z.imag], dim=int(batched))


def join(x, batched: bool = False):
    """Inverse of split."""
    ax = int(batched)
    return torch.complex(x.select(ax, 0), x.select(ax, 1))


def kmesh_supercell(lattice, kpts):
    """The Born-von-Karman supercell of a Monkhorst-Pack mesh: the mesh
    dimensions from the distinct fractional coordinates of the k-points
    along each reciprocal axis (the Madelung constant of exact exchange is
    that of this cell, PySCF's madelung(cell, kpts))."""
    a = lattice._a_np
    frac = np.asarray(kpts) @ a.T / (2.0 * np.pi)
    dims = [len(np.unique(np.round(frac[:, i] % 1.0, 8))) for i in range(3)]
    return Lattice(a * np.asarray(dims, dtype=float)[:, None],
                   device=lattice.a.device)


def has_kpoints(kpts) -> bool:
    """Whether a Sol takes the k-point engine: more than one k-point, or
    one with |k| > 1e-12 (the JAX package's rule)."""
    kpts = np.asarray(kpts)
    return len(kpts) > 1 or float(np.abs(kpts).max()) > 1e-12


def _gspace_matrix(Qre, Qim, ar, ai):
    """sum_G (ar + i ai)(G) Q^k(-G) for every k, complex (nk, nao, nao):
    the transpose of sum_G a(G) conj(Q^k(G)), two GEMVs over each of Qre
    and Qim."""
    nk, ng, n = Qre.shape[0], Qre.shape[1], Qre.shape[-1]
    W = torch.stack([ar, ai])                                  # (2, ng)
    R = torch.matmul(W, Qre.reshape(nk, ng, n * n))            # (nk, 2, n2)
    I = torch.matmul(W, Qim.reshape(nk, ng, n * n))
    x = torch.complex(R[:, 0] + I[:, 1], R[:, 1] - I[:, 0])
    return x.reshape(nk, n, n).transpose(-1, -2)


def _vnuc_k(Qre, Qim, w, atomzs, atompos, Gv):
    """Vne^k = sum_G w_G n(G) Q^k(-G), n(G) = -sum_A Z_A e^{-iG.R_A}."""
    gv = torch.as_tensor(np.asarray(Gv, dtype=np.float64),
                         device=atompos.device)
    ph = gv @ atompos.T
    z = torch.as_tensor(atomzs, dtype=DTYPE, device=atompos.device)
    return _gspace_matrix(Qre, Qim, -w * (torch.cos(ph) @ z),
                          w * (torch.sin(ph) @ z))


def build_kpbc_exx_theta(meta, params, lattice, Gv, kpts, precision=1e-9,
                         kpts_bra=None, lr_omegas=(), params_np=None):
    """The mixed Bloch pair-transform stack of k-point exact exchange. For
    each (k, k') with q = k' - k:

        A^{kk'}_ia(G) = sum_T e^{ik'.T} <phi_i | e^{-i(q+G).r} | phi_a(.-T)>,

    pbc_pair_ft_k on the shifted set q + G (one build per distinct q, its
    Hermite terms shared by the k' of that q), with the weights w(q+G) =
    4 pi / (V |q+G|^2) (only the one singular q + G = 0 term dropped; the
    Madelung term restores it) and, per omega of lr_omegas, the
    short-range weights wqsr{i} = 4 pi (1 - e^{-|q+G|^2/(4 omega^2)}) /
    (V |q+G|^2), finite at q + G = 0 (no drop). kpts_bra (default kpts):
    the bra axis, the band k-points of band_energies.

    Returns {'A': complex (nkb, nk, ng, nao, nao), 'wq': (nkb, nk, ng),
    'wqsr{i}': ...}. The stack grows as nkb nk; past
    config.KPBC_EXX_BYTES_LIMIT it raises."""
    kpts = np.asarray(kpts, dtype=np.float64).reshape(-1, 3)
    kb = kpts if kpts_bra is None else np.asarray(
        kpts_bra, dtype=np.float64).reshape(-1, 3)
    nkb, nk, ng, nao = len(kb), len(kpts), len(Gv), meta.nao
    need = nkb * nk * ng * nao * nao * 16
    if need > config.KPBC_EXX_BYTES_LIMIT:
        raise NotImplementedError(
            f"k-point exact exchange on {nkb} x {nk} k-point pairs needs a "
            f"{need}-byte pair-transform stack, above "
            f"config.KPBC_EXX_BYTES_LIMIT ({config.KPBC_EXX_BYTES_LIMIT} "
            "bytes); use a smaller k-mesh or a functional without exact "
            "exchange")
    dev = params["atompos"].device
    plan = pbc_pair_plan_ordered(meta, params if params_np is None
                                 else params_np, lattice, precision)
    vol = lattice.volume()
    A = torch.empty((nkb, nk, ng, nao, nao), dtype=torch.complex128,
                    device=dev)
    wq = torch.empty((nkb, nk, ng), dtype=DTYPE, device=dev)
    wsr = [torch.empty_like(wq) for _ in lr_omegas]
    groups = {}
    for i in range(nkb):
        for j in range(nk):
            q = kpts[j] - kb[i]
            groups.setdefault(tuple(np.round(q, 12)), (q, []))[1].append(
                (i, j))
    for q, pairs in groups.values():
        gvq = np.asarray(Gv) + q[None, :]
        qre, qim = pbc_pair_ft_k(meta, params, plan, gvq,
                                 kpts[[j for _, j in pairs]])
        g2 = torch.sum(torch.as_tensor(gvq, dtype=DTYPE, device=dev) ** 2,
                       dim=-1)
        nz = g2 > 1e-12
        g2s = torch.where(nz, g2, torch.ones_like(g2))
        w = torch.where(nz, 4.0 * math.pi / (vol * g2s), torch.zeros_like(g2))
        sr = [torch.where(nz, 4.0 * math.pi * -torch.expm1(
            -g2s / (4.0 * float(om) ** 2)) / (vol * g2s),
            math.pi / (float(om) ** 2 * vol) * torch.ones_like(g2))
            for om in lr_omegas]
        for n, (i, j) in enumerate(pairs):
            A[i, j] = torch.complex(qre[n], qim[n])
            wq[i, j] = w
            for t, s in enumerate(sr):
                wsr[t][i, j] = s
        del qre, qim
    out = {"A": A, "wq": wq}
    for t, s in enumerate(wsr):
        out[f"wqsr{t}"] = s
    return out


def build_kpbc_gdf(Qre, Qim, w, chi):
    """The k-point Gaussian fit of the Coulomb term, in factored form:

        T^k_{ij,P} = sum_G w_G Q^k_ij(G) chi_P(G)^*   (complex),
        v_PQ       = sum_G w_G Re[chi_P(G) chi_Q(G)^*],

    B^k = T^k v^(+1/2) with v^(+1/2) the square root of v's pseudo-inverse
    on the eigenvalues above GDF_METRIC_CUTOFF of the largest
    (scf/df.pinv_sqrt), as the port's Gamma fit; the JAX package forms the
    explicit v_inv. Returns {'B': complex (nk, nao, nao, naux)}; J follows
    from c = Re sum_k w_k sum_ij D^k_ij B^k_{ji} and J^k = B^k c
    (KPBCEngine._j)."""
    cre, cim = chi
    nk, ng, n = Qre.shape[0], Qre.shape[1], Qre.shape[-1]
    wre, wim = w[:, None] * cre, w[:, None] * cim
    qr = Qre.reshape(nk, ng, n * n).transpose(1, 2)
    qi = Qim.reshape(nk, ng, n * n).transpose(1, 2)
    Tre = qr @ wre + qi @ wim
    Tim = qi @ wre - qr @ wim
    v = cre.T @ wre + cim.T @ wim
    ph, _ = pinv_sqrt(0.5 * (v + v.T), GDF_METRIC_CUTOFF)
    B = torch.complex(Tre @ ph, Tim @ ph)
    return {"B": B.reshape(nk, n, n, -1)}


def _ao_chunk_k(meta, params, coords, ls_ao, kpts, deriv):
    tabs = eval_ao_pbc_k(meta, params, coords, ls_ao, kpts, deriv=deriv)
    return tuple(tabs[k] for k in ("ao", "ao_grad", "ao_lapl")[:deriv + 1])


def kpbc_ao_tables(meta, params, coords, ls_ao, kpts, family):
    """The Bloch tables of eval_ao_pbc_k at the grid points coords, in
    chunks of AO_PT_CHUNK points (recomputed in the backward under
    autograd): {'ao': (nk, ng, 2 nao), 'ao_grad': (nk, 3, ng, 2 nao),
    'ao_lapl': (nk, ng, 2 nao)} as the family needs them."""
    deriv = _deriv_of_family(family)
    ng, nk, m = coords.shape[0], len(kpts), 2 * meta.nao
    dev = coords.device
    shapes = {"ao": (nk, ng, m), "ao_grad": (nk, 3, ng, m),
              "ao_lapl": (nk, ng, m)}
    keys = ("ao", "ao_grad", "ao_lapl")[:deriv + 1]
    out = {k: torch.empty(shapes[k], dtype=DTYPE, device=dev) for k in keys}
    remat = torch.is_grad_enabled() and coords.requires_grad
    for s in range(0, ng, AO_PT_CHUNK):
        e = min(ng, s + AO_PT_CHUNK)
        args = (meta, params, coords[s:e], ls_ao, kpts, deriv)
        tabs = (checkpoint(_ao_chunk_k, *args, use_reentrant=False)
                if remat else _ao_chunk_k(*args))
        for key, tab in zip(keys, tabs):
            if key == "ao_grad":
                out[key][:, :, s:e] = tab
            else:
                out[key][:, s:e] = tab
    return out


def build_kpbc_grid(sol, params, kpts, family, ls_ao, stats=None):
    """The cell-wrapped grid with Bloch tables at kpts: coords, dvol (Becke
    weights over the virtual atoms), family, and the tables of
    kpbc_ao_tables. `stats` gets becke_s, ao_tables_s, ngrid,
    n_virtual_atoms and n_ao_translations."""
    dev = params["atompos"].device
    pbcgrid = sol.setup_grid()
    t0 = time.perf_counter()
    coords, dvol = pbc_grid_points(params, pbcgrid)
    _sync(dev)
    t1 = time.perf_counter()
    out = {"coords": coords, "dvol": dvol, "family": family}
    out.update(kpbc_ao_tables(sol.meta, params, coords, ls_ao, kpts, family))
    _sync(dev)
    if stats is not None:
        stats.update(becke_s=t1 - t0, ao_tables_s=time.perf_counter() - t1,
                     ngrid=coords.shape[0],
                     n_virtual_atoms=len(pbcgrid.vowner),
                     n_ao_translations=len(ls_ao))
    return out


def build_kpbc_theta(sol, params, atomzs, *, semilocal=True, family=1,
                     with_exx=False, madelung=None, lr_omegas=(),
                     gdf_aux=None, ls_ao=None, stats=None):
    """params -> theta of the k-point SCF: hcore = T + Vne, ovlp (complex
    (nk, nao, nao) lattice sums), the per-k orthogonaliser X (complex) and
    keep (nk, nao), the Ewald nuclei energy, the Bloch pair transforms Qre,
    Qim (nk, ng, nao, nao) with the Coulomb weights wcoul, the k weights wk,
    for a functional with a semilocal part the grid (build_kpbc_grid), with
    gdf_aux = (meta_aux, params_aux) the fit kdf (build_kpbc_gdf), and with
    exact exchange the stack exx (build_kpbc_exx_theta) with its madelung.
    `stats` gets int1e_s, pair_ft_s, vnuc_s, exx_s, gdf_s, grid_s (with
    becke_s, ao_tables_s), nk, n_gvectors, n_pair_terms."""
    meta, lat = sol.meta, sol.lattice
    dev = params["atompos"].device
    kpts = np.asarray(sol.kpts, dtype=np.float64)
    nk = len(kpts)
    times = {"nk": nk}
    t0 = time.perf_counter()
    ls = lat.get_lattice_ls(estimate_rcut(meta, sol.params, CORE_PRECISION))
    S = pbc_overlap(meta, params, ls, kpts)
    T = pbc_kinetic(meta, params, ls, kpts)
    _sync(dev)
    t1 = time.perf_counter()
    Gv, _ = lat.get_gvgrids(gcut_estimate(meta, sol.params, CORE_PRECISION))
    plan = pbc_pair_plan_ordered(meta, sol.params, lat, CORE_PRECISION)
    Qre, Qim = pbc_pair_ft_k(meta, params, plan, Gv, kpts)
    _sync(dev)
    t2 = time.perf_counter()
    w = coulomb_gweights(Gv, lat.volume())
    vne = _vnuc_k(Qre, Qim, w, atomzs, params["atompos"], Gv)
    X, keep = orthogonalizer(S, 1e-9)
    theta = {"hcore": T + vne, "ovlp": S, "X": X, "keep": keep,
             "enuc": ewald_energy(atomzs, params["atompos"], lat),
             "Qre": Qre, "Qim": Qim, "wcoul": w,
             "wk": torch.full((nk,), 1.0 / nk, dtype=DTYPE, device=dev)}
    _sync(dev)
    t3 = time.perf_counter()
    times.update(int1e_s=t1 - t0, n_translations=len(ls), pair_ft_s=t2 - t1,
                 n_gvectors=len(Gv),
                 n_pair_terms=sum(len(q) for _, q, _ in plan),
                 vnuc_s=t3 - t2)
    if gdf_aux is not None:
        meta_aux, params_aux = gdf_aux
        theta["kdf"] = build_kpbc_gdf(Qre, Qim, w,
                                      eval_ao_ft(meta_aux, params_aux, Gv))
        _sync(dev)
        times.update(gdf_s=time.perf_counter() - t3, naux=meta_aux.nao)
    if with_exx:
        t4 = time.perf_counter()
        theta["exx"] = build_kpbc_exx_theta(
            meta, params, lat, Gv, kpts, CORE_PRECISION,
            lr_omegas=lr_omegas, params_np=sol.params)
        theta["exx"]["madelung"] = madelung
        _sync(dev)
        times["exx_s"] = time.perf_counter() - t4
    if semilocal:
        t5 = time.perf_counter()
        theta["grid"] = build_kpbc_grid(sol, params, kpts, family, ls_ao,
                                        stats=times)
        times["grid_s"] = time.perf_counter() - t5
    if stats is not None:
        stats.update(times)
    return theta


def _embed(dmc, wk):
    """w_k [[P, Q], [-Q, P]] ([B,] nk, 2 nao, 2 nao) of D^k = P + iQ."""
    P, Q = dmc.real, dmc.imag
    m = torch.cat([torch.cat([P, Q], -1), torch.cat([-Q, P], -1)], -2)
    return m * wk[..., None, None]


def _tables_k(grid, k):
    """The tables at k-point k: views, for a batch (B, nk, ...) the
    members' tables at k, each member's block contiguous (read in place by
    K2/K3)."""
    tabs = {"ao": grid["ao"].select(-3, k)}
    if "ao_grad" in grid:
        tabs["ao_grad"] = grid["ao_grad"].select(-4, k)
    if "ao_lapl" in grid:
        tabs["ao_lapl"] = grid["ao_lapl"].select(-3, k)
    return tabs


def _complex_tables(grid):
    """The complex Bloch tables of the real embedding, in the JAX package's
    layouts: phi (nk, ng, nao), grad (nk, ng, 3, nao), lapl (nk, ng, nao)."""
    n = grid["ao"].shape[-1] // 2

    def c(t):
        return torch.complex(t[..., :n], t[..., n:])
    out = {"ao": c(grid["ao"])}
    if "ao_grad" in grid:
        out["ao_grad"] = c(grid["ao_grad"]).permute(0, 2, 1, 3)
    if "ao_lapl" in grid:
        out["ao_lapl"] = c(grid["ao_lapl"])
    return out


class KPBCEngine:
    """Restricted/unrestricted k-point Kohn-Sham (and HF: xc "hf") with LDA,
    GGA and meta-GGA functionals, hybrid and range-separated exact exchange
    and the k-point fit (module docstring). The state is the stacked (re,
    im) real form of D^k; theta comes from build_kpbc_theta.

    A batch of cells (parallel/batch.py): theta's tensors stacked on a
    leading member axis (X (B, nk, nao, nao)) and the state (B, 2, [2,]
    nk, nao, nao), whose member m is member m's unbatched state. The XC
    runs for all members at once: K2 and K3 once per k-point and spin per
    Fock build, each on the members' tables at that k (strided views, read
    in place). J, the exchange, the eigensolves and the energy's other
    terms run member by member, each on its member's theta."""

    def __init__(self, xc, nk: int, nao: int, polarized: bool = False):
        self.xc = xc
        self.nk = nk
        self.nao = nao
        self.polarized = polarized
        self.hyb = float(getattr(xc, "exx_fraction", 0.0))
        # range-separated terms [(coef, omega), ...]: LR = full - SR
        self.exx_lr = tuple(getattr(xc, "exx_lr", ()) or ())
        # pure exact exchange has no semilocal part: no grid, E_xc = 0
        self.semilocal = not isinstance(xc, HFExchangeXC)

    @property
    def has_exx(self):
        return self.hyb != 0.0 or bool(self.exx_lr)

    def dm_tot(self, dmc):
        return dmc.sum(dim=0) if self.polarized else dmc

    def init_dm(self, device, batch=None):
        """The zero state (the core guess), of `batch` members when given."""
        shape = ((2, 2) if self.polarized else (2,)) + (
            self.nk, self.nao, self.nao)
        if batch is not None:
            shape = (batch,) + shape
        return torch.zeros(shape, dtype=DTYPE, device=device)

    @staticmethod
    def _batched(theta):
        """Whether theta is a batch's (a leading member axis on X)."""
        return theta["X"].ndim == 4

    @staticmethod
    def _members(fn, nb):
        """fn(m) of every member m of a batch, stacked."""
        return stack_members([fn(m) for m in range(nb)])

    # --- Coulomb ---------------------------------------------------------
    def _rho_g(self, dmt, theta):
        """(Re, Im) of rho(G) = sum_k w_k sum_ij D^k_ij Q^k_ji(G)."""
        Qre, Qim = theta["Qre"], theta["Qim"]
        nk, ng, n = Qre.shape[0], Qre.shape[1], Qre.shape[-1]
        d = dmt.transpose(-1, -2).reshape(nk, n * n)
        dd = torch.stack([d.real, d.imag], dim=-1)         # (nk, n2, 2)
        R = torch.bmm(Qre.reshape(nk, ng, n * n), dd)       # (nk, ng, 2)
        I = torch.bmm(Qim.reshape(nk, ng, n * n), dd)
        wk = theta["wk"][:, None]
        return ((wk * (R[..., 0] - I[..., 1])).sum(0),
                (wk * (R[..., 1] + I[..., 0])).sum(0))

    def _j(self, dmt, theta):
        if "kdf" in theta:
            B = theta["kdf"]["B"]
            b = torch.einsum("k,kij,kjip->p", theta["wk"].to(dmt.dtype),
                             dmt, B)
            j = torch.einsum("kijp,p->kij", B, b.real.to(B.dtype))
            return 0.5 * (j + j.mH)
        rr, ri = self._rho_g(dmt, theta)
        w = theta["wcoul"]
        return _gspace_matrix(theta["Qre"], theta["Qim"], w * rr, w * ri)

    # --- XC through K2/K3 on the real embedding ----------------------------
    def _dens_of(self, dmc, theta):
        """{rho, grad (3, ng), lapl, tau} of sum_k w_k D^k: K2 once per k
        on (u^k, w_k M^k)."""
        g = theta["grid"]
        m = _embed(dmc, theta["wk"])
        out = None
        for k in range(dmc.shape[-3]):
            d = density_from_tables(_tables_k(g, k), m.select(-3, k),
                                    self.xc.family, polarized=False)
            out = d if out is None else {key: out[key] + d[key]
                                         for key in out}
        return out

    def _dens(self, dmc, theta):
        if self.polarized:
            return {"u": self._dens_of(dmc.select(-4, 0), theta),
                    "d": self._dens_of(dmc.select(-4, 1), theta)}
        return self._dens_of(dmc, theta)

    def _assemble(self, vbar, grid):
        """V^k (complex, Hermitian part) from the pointwise adjoints: K3 once
        per k on u^k, V^k = (W_aa + W_bb) + i (W_ab - W_ba). No w_k factor:
        F^k is the band Fock matrix."""
        n = self.nao
        W = torch.stack([_vxc_assemble(vbar, _tables_k(grid, k))
                         for k in range(grid["ao"].shape[-3])], dim=-3)
        v = torch.complex(W[..., :n, :n] + W[..., n:, n:],
                          W[..., :n, n:] - W[..., n:, :n])
        return 0.5 * (v + v.mH)

    def _vxc_of(self, vbar, grid):
        if self.polarized:
            return torch.stack([self._assemble(vbar["u"], grid),
                                self._assemble(vbar["d"], grid)], dim=-4)
        return self._assemble(vbar, grid)

    def _exc_vxc(self, dmc, theta):
        exc, vbar = _pointwise_adjoints(
            self.xc, self._dens(dmc, theta), theta["grid"]["dvol"],
            self.polarized, theta.get("xc_params"))
        return exc, self._vxc_of(vbar, theta["grid"])

    def _exc(self, dmc, theta):
        e = _edens_at(self.xc, self._dens(dmc, theta), self.polarized,
                      theta.get("xc_params"))
        if self._batched(theta):
            return torch.sum(e * theta["grid"]["dvol"], dim=-1)
        return torch.sum(e * theta["grid"]["dvol"])

    # the plain version: the JAX package's complex einsums (kpbc.py:307-376)
    def _dens_plain(self, dmc, theta):
        tabs = _complex_tables(theta["grid"])
        phi = tabs["ao"]
        wk = theta["wk"].to(dmc.dtype)
        fam = self.xc.family

        def one(d):
            out = {"rho": torch.einsum("k,kij,kgi,kgj->g", wk, d, phi,
                                       phi.conj()).real}
            if fam >= 2:
                gphi = tabs["ao_grad"]
                out["grad"] = 2.0 * torch.einsum(
                    "k,kij,kgdi,kgj->dg", wk, d, gphi, phi.conj()).real
            if fam >= 4:
                gg = torch.einsum("k,kij,kgdi,kgdj->g", wk, d, gphi,
                                  gphi.conj()).real
                t1 = torch.einsum("k,kij,kgi,kgj->g", wk, d,
                                  tabs["ao_lapl"], phi.conj()).real
                out["lapl"] = 2.0 * t1 + 2.0 * gg
                out["tau"] = 0.5 * gg
            return out
        if self.polarized:
            return {"u": one(dmc[0]), "d": one(dmc[1])}
        return one(dmc)

    def _assemble_plain(self, vbar, grid):
        tabs = _complex_tables(grid)
        phi = tabs["ao"]

        def one(vb):
            c = phi.dtype
            raw = torch.einsum("g,kgi,kgj->kij", vb["rho"].to(c), phi.conj(),
                               phi)
            if vb.get("grad") is not None:
                raw = raw + 2.0 * torch.einsum(
                    "dg,kgdi,kgj->kij", vb["grad"].to(c),
                    tabs["ao_grad"].conj(), phi)
            if vb.get("lapl") is not None:
                gphi = tabs["ao_grad"]
                raw = raw + 2.0 * torch.einsum(
                    "g,kgi,kgj->kij", vb["lapl"].to(c),
                    tabs["ao_lapl"].conj(), phi)
                raw = raw + 2.0 * torch.einsum(
                    "g,kgdi,kgdj->kij", vb["lapl"].to(c), gphi.conj(), gphi)
            if vb.get("tau") is not None:
                gphi = tabs["ao_grad"]
                raw = raw + 0.5 * torch.einsum(
                    "g,kgdi,kgdj->kij", vb["tau"].to(c), gphi.conj(), gphi)
            return 0.5 * (raw + raw.mH)
        if self.polarized:
            return torch.stack([one(vbar["u"]), one(vbar["d"])])
        return one(vbar)

    def exc_vxc_plain(self, x, theta):
        """(E_xc, V_xc^k) at a state through the complex einsums: the plain
        version the kernel path is held against."""
        dmc = join(x)
        exc, vbar = _pointwise_adjoints(
            self.xc, self._dens_plain(dmc, theta), theta["grid"]["dvol"],
            self.polarized, theta.get("xc_params"))
        return exc, self._assemble_plain(vbar, theta["grid"])

    # --- exact exchange ----------------------------------------------------
    def _k_all(self, dmc, theta):
        """(K_full, [K_lr per exx_lr term]):

            K^k = sum_k' w_k' sum_G w(q+G) A^{kk'}(G) D^{k'} A^{kk'}(G)^H,

        over G blocks of the stack (t = A D is never whole), the short-range
        weights wqsr{i} sharing each block's t; LR = full - SR; the Madelung
        term M S^k D^k S^k on the full kernel (and so on each LR term). A
        leading spin axis of dmc gives per-spin exchange."""
        ex = theta["exx"]
        A = ex["A"]
        nkb, nk, ng, n = A.shape[0], A.shape[1], A.shape[2], A.shape[-1]
        ws = [ex["wq"]] + [ex[f"wqsr{i}"] for i in range(len(self.exx_lr))]
        wk = theta["wk"]
        lead = dmc.shape[:-3]
        nspin = dmc[..., 0, 0, 0].numel()
        gc = _g_block(16.0 * n * n * (2 + 2 * nspin), ng, dmc.device)

        def block(g0, g1, a, d, *w):
            a = a[g0:g1]
            t = a @ d.unsqueeze(-3)                         # (..., gc, n, n)
            rhs = a.transpose(0, 1).reshape(n, -1).conj().T
            return tuple((t * wi[g0:g1, None, None]).transpose(-3, -2)
                         .reshape(lead + (n, -1)) @ rhs for wi in w)

        ks = [[] for _ in ws]
        for x in range(nkb):
            acc = [0.0 for _ in ws]
            for y in range(nk):
                for _, _, parts in _blocked(
                        block, ng, gc, A[x, y], dmc[..., y, :, :],
                        *[w[x, y] for w in ws], remat=True):
                    acc = [a + wk[y] * p for a, p in zip(acc, parts)]
            for lst, a in zip(ks, acc):
                lst.append(a)
        ks = [torch.stack(lst, dim=-3) for lst in ks]
        k, k_lrs = ks[0], [ks[0] - ksr for ksr in ks[1:]]
        mad = ex.get("madelung")
        if mad is not None:
            s = theta["ovlp"]
            corr = mad * (s @ dmc @ s)
            k = k + corr
            k_lrs = [kl + corr for kl in k_lrs]
        return k, k_lrs

    # --- SCF pieces (states in the stacked real form) ----------------------
    def jk_parts(self, x, theta):
        """(J^k of the total density, (K_full, K_lr list) or None); a batch
        member by member."""
        if self._batched(theta):
            return self._members(lambda m: self.jk_parts(
                x[m], tree_member(theta, m)), x.shape[0])
        dmc = join(x)
        j = self._j(self.dm_tot(dmc), theta)
        return j, (self._k_all(dmc, theta) if self.has_exx else None)

    def fock_from_parts(self, x, j, k, theta):
        """F^k from J and K; V_xc of every member of a batch at once."""
        batched = self._batched(theta)
        dmc = join(x, batched)
        f = theta["hcore"] + j
        if self.polarized:
            f = f.unsqueeze(-4).expand(f.shape[:-3] + (2,) + f.shape[-3:])
        if self.semilocal:
            f = f + self._exc_vxc(dmc, theta)[1]
        if k is not None:
            kf, k_lrs = k
            fac = 1.0 if self.polarized else 0.5
            if self.hyb != 0.0:
                f = f - fac * self.hyb * kf
            for (c, _), klr in zip(self.exx_lr, k_lrs):
                f = f - fac * c * klr
        return split(f, batched)

    def fock(self, x, theta):
        return self.fock_from_parts(x, *self.jk_parts(x, theta), theta)

    @staticmethod
    def _orthogonal_fock(fx, theta):
        """X^H F^k X with the directions the basis drops at k pinned at
        LARGE, so they are never occupied."""
        X = theta["X"]
        pin = torch.where(theta["keep"], torch.zeros_like(X.real[..., 0, :]),
                          torch.full_like(X.real[..., 0, :], LARGE))
        return X.mH @ join(fx) @ X + torch.diag_embed(pin).to(X.dtype)

    def dm_from_fock(self, fx, theta):
        if self._batched(theta):
            return self._members(lambda m: self.dm_from_fock(
                fx[m], tree_member(theta, m)), fx.shape[0])
        occ = theta["occ"]
        if self.polarized:
            occ = occ[:, None, :]
        p, _, _ = eigh_density(self._orthogonal_fock(fx, theta), occ)
        X = theta["X"]
        return split(X @ p @ X.mH)

    def step(self, x, theta):
        return self.dm_from_fock(self.fock(x, theta), theta)

    def energy_from_parts(self, x, j, k, theta, exc=None):
        """The total energy ((B,) for a batch: E_xc of all members at once,
        the rest member by member)."""
        if self._batched(theta):
            if exc is None and self.semilocal:
                exc = self._exc(join(x, True), theta)
            return self._members(lambda m: self.energy_from_parts(
                x[m], None if j is None else j[m], _member_of(k, m),
                tree_member(theta, m), None if exc is None else exc[m]),
                x.shape[0])
        dmc = join(x)
        dmt = self.dm_tot(dmc)
        wk = theta["wk"].to(dmt.dtype)
        e1 = torch.einsum("k,kij,kji->", wk, theta["hcore"], dmt).real
        if "kdf" in theta:
            ej = 0.5 * torch.einsum("k,kij,kji->", wk, dmt, j).real
        else:
            rr, ri = self._rho_g(dmt, theta)
            ej = 0.5 * torch.sum(theta["wcoul"] * (rr * rr + ri * ri))
        if exc is None:
            exc = self._exc(dmc, theta) if self.semilocal else 0.0
        e = e1 + ej + exc + theta["enuc"]
        if k is not None:
            kf, k_lrs = k
            fac = 0.5 if self.polarized else 0.25

            def tr_k(kk):
                return torch.einsum("k,...kij,...kji->", wk, dmc, kk).real
            if self.hyb != 0.0:
                e = e - fac * self.hyb * tr_k(kf)
            for (c, _), klr in zip(self.exx_lr, k_lrs):
                e = e - fac * c * tr_k(klr)
        return e

    def energy(self, x, theta):
        if self._batched(theta):
            exc = (self._exc(join(x, True), theta) if self.semilocal
                   else None)
            return self._members(lambda m: self._energy_member(
                x[m], tree_member(theta, m),
                None if exc is None else exc[m]), x.shape[0])
        return self._energy_member(x, theta)

    def _energy_member(self, x, theta, exc=None):
        dmc = join(x)
        j = self._j(self.dm_tot(dmc), theta) if "kdf" in theta else None
        k = self._k_all(dmc, theta) if self.has_exx else None
        return self.energy_from_parts(x, j, k, theta, exc=exc)

    def diis_err(self, fx, x, theta):
        if self._batched(theta):
            return self._members(lambda m: self.diis_err(
                fx[m], x[m], tree_member(theta, m)), fx.shape[0])
        s, X = theta["ovlp"], theta["X"]
        fds = join(fx) @ join(x) @ s
        return split(X.mH @ (fds - fds.mH) @ X)

    def eigenvalues(self, fx, theta):
        """Band energies (ascending, (..., nk, nao)) of Fock matrices; the
        masked directions pinned at LARGE; a batch member by member."""
        if self._batched(theta):
            return self._members(lambda m: self.eigenvalues(
                fx[m], tree_member(theta, m)), fx.shape[0])
        return torch.linalg.eigvalsh(self._orthogonal_fock(fx, theta))


def _member_of(part, m):
    """Member m of a batch's exchange (K_full, [K_lr, ...]), or None."""
    if part is None:
        return None
    kf, k_lrs = part
    return kf[m], [kl[m] for kl in k_lrs]


def band_energies(qc, kpts_band):
    """Band energies eps_n(k) at any k-points from a converged k-point
    calculation (the JAX package's band_energies): the converged effective
    Hamiltonian T + Vne + J[rho] + V_xc[rho] (- K for exact exchange, from
    the rectangular band-k x mesh-k' pair-transform stack) rebuilt in the
    Bloch basis at each band k, and its generalized eigenvalues.

    Returns (nkb, nao) ((2, nkb, nao) polarized), ascending, in Hartree;
    directions the basis drops at a k are pinned near LARGE. The Madelung
    term of exact exchange applies at band points that lie on the mesh
    (the usual get_bands convention); off the mesh, hybrid bands sample
    the integrable 1/q^2 of the exchange kernel and need a denser mesh."""
    eng = qc.engine
    if not isinstance(eng, KPBCEngine):
        raise TypeError(
            "band_energies needs a k-point calculation: build the Sol with "
            "kpts=... (a one-point mesh away from Gamma counts)")
    assert qc._has_run, "call .run() first"
    sol, theta = qc.mol, qc._theta
    dmc = join(qc._dm)
    meta, lat = sol.meta, sol.lattice
    p = qc._all_params()
    params, atomzs = p["basis"], p["atomzs"]
    kb = np.asarray(kpts_band, dtype=np.float64).reshape(-1, 3)
    with torch.no_grad():
        ls = lat.get_lattice_ls(estimate_rcut(meta, sol.params,
                                              CORE_PRECISION))
        S = pbc_overlap(meta, params, ls, kb)
        T = pbc_kinetic(meta, params, ls, kb)
        Gv, _ = lat.get_gvgrids(gcut_estimate(meta, sol.params,
                                              CORE_PRECISION))
        plan = pbc_pair_plan_ordered(meta, sol.params, lat, CORE_PRECISION)
        Qre, Qim = pbc_pair_ft_k(meta, params, plan, Gv, kb)
        w = theta["wcoul"]
        vne = _vnuc_k(Qre, Qim, w, atomzs, params["atompos"], Gv)
        # the Hartree potential of the converged G-space density
        rr, ri = eng._rho_g(eng.dm_tot(dmc), theta)
        f = T + vne + _gspace_matrix(Qre, Qim, w * rr, w * ri)
        del Qre, Qim
        if eng.polarized:
            f = f[None].expand((2,) + f.shape)
        if eng.semilocal:
            _, vbar = _pointwise_adjoints(
                eng.xc, eng._dens(dmc, theta), theta["grid"]["dvol"],
                eng.polarized, theta.get("xc_params"))
            g = theta["grid"]
            ls_ao = lat.get_lattice_ls(estimate_rcut(meta, sol.params,
                                                     AO_PRECISION))
            gridb = kpbc_ao_tables(meta, params, g["coords"], ls_ao, kb,
                                   eng.xc.family)
            f = f + eng._vxc_of(vbar, gridb)
            del gridb
        if eng.has_exx:
            exxb = build_kpbc_exx_theta(
                meta, params, lat, Gv, sol.kpts, CORE_PRECISION, kpts_bra=kb,
                lr_omegas=[om for _, om in eng.exx_lr], params_np=sol.params)
            K_full, K_lrs = eng._k_all(dmc, {"exx": exxb, "wk": theta["wk"]})
            del exxb
            K = eng.hyb * K_full
            for (c, _), kl in zip(eng.exx_lr, K_lrs):
                K = K + c * kl
            mad = theta["exx"].get("madelung")
            if mad is not None:
                # the full kernel's term of every exchange term, at band
                # points on the mesh
                ctot = eng.hyb + sum(c for c, _ in eng.exx_lr)
                mesh = np.asarray(sol.kpts)
                corr = torch.zeros_like(K)
                for b in range(len(kb)):
                    hits = np.flatnonzero(np.all(np.abs(mesh - kb[b]) < 1e-9,
                                                 axis=1))
                    if len(hits):
                        corr[..., b, :, :] = ctot * mad * (
                            S[b] @ dmc[..., int(hits[0]), :, :] @ S[b])
                K = K + corr
            f = f - (1.0 if eng.polarized else 0.5) * K
        X, keep = orthogonalizer(S, 1e-9)
        return eng.eigenvalues(split(f), {"X": X, "keep": keep})
