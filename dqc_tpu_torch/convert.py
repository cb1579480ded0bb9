"""Carrying parameters and state across from the JAX package.

The caller turns the JAX package's `mol.params` tree, a `theta` dict or the
parameter tree of a CustomXC into numpy arrays (np.asarray on the JAX
side); these functions return the port's tensors on the requested device. This module imports neither jax nor
the JAX package. With it a test can put the JAX package's integrals through
the port's engine, and compare one stage at a time.
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
