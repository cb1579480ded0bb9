"""Carrying parameters and state across from the JAX package.

The caller turns the JAX package's `mol.params` tree, a `theta` dict or the
parameter tree of a CustomXC into numpy arrays (np.asarray on the JAX
side); these functions return the port's tensors on the requested device. This module imports neither jax nor
the JAX package. With it a test can put the JAX package's integrals through
the port's engine, and compare one stage at a time. The k-point theta of
kpbc_theta_from_numpy also takes complex arrays, as complex128 or as (re,
im) pairs.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.config import DTYPE, resolve_device


def _f64(x, device):
    # torch.tensor copies: the result never aliases the caller's array
    return torch.tensor(np.asarray(x, dtype=np.float64), dtype=DTYPE,
                        device=device)


def params_from_numpy(params_np: dict, device=None) -> dict:
    """`params` of the port from the JAX package's params tree as numpy:
    atompos (natm,3); per shell class alphas, coeffs, mask (ns,kmax)."""
    device = resolve_device(device)
    return {
        "atompos": _f64(params_np["atompos"], device),
        "alphas": [_f64(a, device) for a in params_np["alphas"]],
        "coeffs": [_f64(a, device) for a in params_np["coeffs"]],
        "mask": [_f64(a, device) for a in params_np["mask"]],
    }


def theta_from_numpy(theta_np: dict, device=None) -> dict:
    """`theta` of the port from a theta dict of the JAX package as numpy.

    Takes hcore, ovlp, X, keep, enuc, occ and eri_k; a J-layout `eri`
    ((ij|kl)) is turned into the exchange layout eri_k the port's engine
    consumes. A periodic theta also brings its pair transforms `pbcft`
    (Fre, Fim, wcoul, wsr{i}, madelung) and its fits `df` and `df_sr{i}`
    (df_from_numpy). Other keys (grid tables, kernel planes) are not
    carried."""
    device = resolve_device(device)
    out = {}
    for key in ("hcore", "ovlp", "X", "enuc", "occ"):
        if key in theta_np:
            out[key] = _f64(theta_np[key], device)
    if "keep" in theta_np:
        out["keep"] = torch.tensor(
            np.asarray(theta_np["keep"], dtype=bool), device=device)
    if "eri_k" in theta_np:
        out["eri_k"] = _f64(theta_np["eri_k"], device)
    elif "eri" in theta_np:
        out["eri_k"] = _f64(theta_np["eri"], device).permute(
            0, 2, 1, 3).contiguous()
    if "pbcft" in theta_np:
        out["pbcft"] = {
            k: ((None if v is None else float(v)) if k == "madelung"
                else _f64(v, device))
            for k, v in theta_np["pbcft"].items()}
    for key, df in theta_np.items():
        if key == "df" or key.startswith("df_sr"):
            out[key] = df_from_numpy(df, device)
    return out


def _c128(x, device):
    """A complex128 tensor from a complex numpy array or an (re, im) pair."""
    if isinstance(x, (tuple, list)):
        x = np.asarray(x[0], dtype=np.float64) + 1j * np.asarray(
            x[1], dtype=np.float64)
    return torch.tensor(np.asarray(x, dtype=np.complex128), device=device)


def _embedded(x):
    """[Re | Im] on the last axis of a complex numpy array or (re, im)."""
    if isinstance(x, (tuple, list)):
        re, im = (np.asarray(v, dtype=np.float64) for v in x)
    else:
        re, im = np.real(x), np.imag(x)
    return np.concatenate([re, im], axis=-1)


def kpbc_theta_from_numpy(theta_np: dict, device=None) -> dict:
    """`theta` of the port's k-point engine (scf/kpbc.py) from a theta of
    the JAX package's KPBCEngine as numpy. Complex arrays may come as
    complex128 arrays or as (re, im) pairs. Takes hcore, ovlp, X (complex
    (nk, nao, nao)), keep, enuc, occ, wk, wcoul, the Bloch transforms Qre and
    Qim (nk, ng, nao, nao), the grid ({dvol, coords, ao, ao_grad, ao_lapl}
    with complex tables (nk, ng, nao), (nk, ng, 3, nao), (nk, ng, nao),
    stored in the port's real embedding [Re | Im]: (nk, ng, 2 nao) and
    (nk, 3, ng, 2 nao)), the exchange stack exx ({Are, Aim, wq, wqsr{i},
    madelung} -> {A complex, ...}) and the fit kdf ({Tre, Tim, v_inv} ->
    {B = T v_inv^(1/2)}, as df_from_numpy). negG is not carried: the port
    uses Q^k(-G) = conj(Q^k(G))^T."""
    device = resolve_device(device)
    out = {}
    for key in ("hcore", "ovlp", "X"):
        out[key] = _c128(theta_np[key], device)
    for key in ("enuc", "occ", "wk", "wcoul", "Qre", "Qim"):
        if key in theta_np:
            out[key] = _f64(theta_np[key], device)
    out["keep"] = torch.tensor(np.asarray(theta_np["keep"], dtype=bool),
                               device=device)
    g = theta_np.get("grid")
    if g is not None:
        grid = {"dvol": _f64(g["dvol"], device), "ao": _f64(
            _embedded(g["ao"]), device)}
        if "coords" in g:
            grid["coords"] = _f64(g["coords"], device)
        family = 1
        if "ao_grad" in g:
            grid["ao_grad"] = _f64(np.swapaxes(_embedded(g["ao_grad"]), 1, 2),
                                   device)
            family = 2
        if "ao_lapl" in g:
            grid["ao_lapl"] = _f64(_embedded(g["ao_lapl"]), device)
            family = 4
        grid["family"] = family
        out["grid"] = grid
    ex = theta_np.get("exx")
    if ex is not None:
        exx = {"A": _c128((ex["Are"], ex["Aim"]), device),
               "madelung": (None if ex.get("madelung") is None
                            else float(ex["madelung"]))}
        for key, v in ex.items():
            if key == "wq" or key.startswith("wqsr"):
                exx[key] = _f64(v, device)
        out["exx"] = exx
    kdf = theta_np.get("kdf")
    if kdf is not None:
        w, v = np.linalg.eigh(np.asarray(kdf["v_inv"], dtype=np.float64))
        half = (v * np.sqrt(np.clip(w, 0.0, None))[None, :]) @ v.T
        t = np.asarray(kdf["Tre"]) + 1j * np.asarray(kdf["Tim"])
        out["kdf"] = {"B": _c128(np.einsum("kijp,pq->kijq", t, half),
                                 device)}
    return out


def df_from_numpy(df_np: dict, device=None) -> dict:
    """A periodic fit of the JAX package ({'j3c': (nao, nao, naux), 'v_inv':
    (naux, naux)}, with 'madelung' and 'ovlp' when it carries the exchange's
    G = 0 term) in the port's factored form {'B': (nao, naux, nao)}: B_Q =
    sum_P j3c_P (v_inv^(1/2))_PQ, so that sum_Q B_Q x B_Q = j3c v_inv j3c;
    v_inv's square root from its eigenvalues, those below zero (rounding
    of the pseudo-inverse's dropped part) taken as zero."""
    device = resolve_device(device)
    w, v = np.linalg.eigh(np.asarray(df_np["v_inv"], dtype=np.float64))
    half = (v * np.sqrt(np.clip(w, 0.0, None))[None, :]) @ v.T
    b = np.einsum("ikp,pq->iqk", np.asarray(df_np["j3c"]), half)
    out = {"B": _f64(b, device)}
    if df_np.get("madelung") is not None:
        out["madelung"] = float(df_np["madelung"])
        out["ovlp"] = _f64(df_np["ovlp"], device)
    return out


def grid_theta_from_numpy(coords, dvol, ao, ao_grad=None, ao_lapl=None,
                          family: int = None, device=None) -> dict:
    """Grid tables of the port (xc/integrate.setup_grid_theta's dict) from
    the JAX package's grid theta as numpy: coords (ng, 3), dvol (ng,),
    ao (ng, nao), ao_grad (3, ng, nao) — the layout both packages store —
    and ao_lapl (ng, nao). With it both packages integrate on identical
    tables, so XC comparisons do not depend on the grid port."""
    device = resolve_device(device)
    if family is None:
        family = 1 if ao_grad is None else (2 if ao_lapl is None else 4)
    out = {"coords": _f64(coords, device), "dvol": _f64(dvol, device),
           "ao": _f64(ao, device), "family": family}
    if ao_grad is not None:
        ag = np.asarray(ao_grad)
        if ag.shape[0] != 3 or ag.shape[1:] != np.shape(ao):
            raise ValueError(f"ao_grad must be (3, ng, nao), got {ag.shape}")
        out["ao_grad"] = _f64(ag, device)
    if ao_lapl is not None:
        out["ao_lapl"] = _f64(ao_lapl, device)
    return out


def xc_params_from_numpy(tree, device=None):
    """The parameters of a CustomXC (xc/custom.py) from the JAX package's
    parameter pytree as numpy: nested dicts, lists and tuples keep their
    structure, every array or number becomes a float64 tensor (0-d for a
    scalar). With it the same NN runs through both packages."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: xc_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(xc_params_from_numpy(v, device) for v in tree)
    return _f64(tree, device)


def batch_params_from_numpy(params_np: dict, device=None) -> dict:
    """A batched params tree of the port (parallel/batch.energy_batch) from
    the JAX package's params tree as numpy with a leading batch axis on
    basis.atompos (B, natom, 3) and, where they vary, atomzs (B, natom):
    the tree a jax.vmap over geometries maps. atomzs given per molecule
    (natom,) is shared by every member; xc_params, when present, stay
    shared (xc_params_from_numpy)."""
    device = resolve_device(device)
    basis = params_np["basis"]
    pos = np.asarray(basis["atompos"], dtype=np.float64)
    if pos.ndim != 3:
        raise ValueError(f"atompos must be (B, natom, 3), got {pos.shape}")
    out = {"basis": params_from_numpy(basis, device)}
    zs = np.asarray(params_np["atomzs"], dtype=np.float64)
    out["atomzs"] = _f64(np.broadcast_to(zs, pos.shape[:2]), device)
    if params_np.get("xc_params") is not None:
        out["xc_params"] = xc_params_from_numpy(params_np["xc_params"],
                                                device)
    return out
