"""XC resolver: libxc-style names and expressions -> torch functionals
(counterpart of dqc_tpu/xc/getxc.py).

Strings like "lda_x", "gga_x_pbe+gga_c_pbe", "0.25*hf+0.75*gga_x_b88" and
the named composites (b3lyp, pbe0, ...). Meta-GGA pieces and the
range-separated ones are not ported yet: names that need them raise
NotImplementedError naming ROADMAP A10.
"""
from __future__ import annotations

import re

from .base import BaseXC, HFExchangeXC
from .gga import (GGA_C_LYP, GGA_C_PBE, GGA_C_PBE_SOL, GGA_X_B88, GGA_X_OPTX,
                  GGA_X_PBE, GGA_X_PBE_SOL, GGA_X_REVPBE, GGA_X_RPBE)
from .lda import LDA_C_PW, LDA_C_PZ, LDA_C_VWN3, LDA_C_VWN5, LDA_X

_REGISTRY = {
    "lda_x": LDA_X,
    "lda_c_pw": LDA_C_PW,
    "lda_c_pw_mod": LDA_C_PW,
    "lda_c_vwn": LDA_C_VWN5,
    "lda_c_vwn5": LDA_C_VWN5,
    "lda_c_vwn_rpa": LDA_C_VWN3,
    "lda_c_vwn3": LDA_C_VWN3,
    "lda_c_pz": LDA_C_PZ,
    "lda_c_pz_mod": LDA_C_PZ,
    "gga_x_pbe": GGA_X_PBE,
    "gga_c_pbe": GGA_C_PBE,
    "gga_x_pbe_sol": GGA_X_PBE_SOL,
    "gga_c_pbe_sol": GGA_C_PBE_SOL,
    "gga_x_pbe_r": GGA_X_REVPBE,   # libxc name for revPBE exchange
    "gga_x_rpbe": GGA_X_RPBE,
    "gga_x_b88": GGA_X_B88,
    "gga_c_lyp": GGA_C_LYP,
    "gga_x_optx": GGA_X_OPTX,
    "hf": HFExchangeXC,
}

# names of the JAX package whose pieces are not ported yet
_NOT_PORTED = ("mgga_x_scan", "mgga_c_scan", "mgga_x_tpss", "mgga_c_tpss",
               "lr_hf", "sr_hf", "lda_x_erf", "gga_x_ityh_b88",
               "scan", "tpss", "tpssh", "scan0", "camb3lyp", "cam-b3lyp",
               "lc-blyp", "lc_blyp")


def _named_composites():
    return {
        # Gaussian-convention B3LYP (VWN3/RPA), libxc hyb_gga_xc_b3lyp
        "b3lyp": lambda: (0.2 * HFExchangeXC() + 0.08 * LDA_X()
                          + 0.72 * GGA_X_B88() + 0.19 * LDA_C_VWN3()
                          + 0.81 * GGA_C_LYP()),
        "b3lyp5": lambda: (0.2 * HFExchangeXC() + 0.08 * LDA_X()
                           + 0.72 * GGA_X_B88() + 0.19 * LDA_C_VWN5()
                           + 0.81 * GGA_C_LYP()),
        "pbe0": lambda: (0.25 * HFExchangeXC() + 0.75 * GGA_X_PBE()
                         + GGA_C_PBE()),
        "pbe": lambda: GGA_X_PBE() + GGA_C_PBE(),
        "pbesol": lambda: GGA_X_PBE_SOL() + GGA_C_PBE_SOL(),
        "revpbe": lambda: GGA_X_REVPBE() + GGA_C_PBE(),
        "rpbe": lambda: GGA_X_RPBE() + GGA_C_PBE(),
        "blyp": lambda: GGA_X_B88() + GGA_C_LYP(),
        "olyp": lambda: GGA_X_OPTX() + GGA_C_LYP(),
        "bhandhlyp": lambda: (0.5 * HFExchangeXC() + 0.5 * GGA_X_B88()
                              + GGA_C_LYP()),
        "svwn": lambda: LDA_X() + LDA_C_VWN5(),
        "lda": lambda: LDA_X() + LDA_C_PW(),
    }


def _not_ported(name):
    return NotImplementedError(
        f"not ported yet: XC functional {name!r} needs the meta-GGA or "
        "range-separated pieces (ROADMAP A10)")


def get_libxc(name: str) -> BaseXC:
    key = name.strip().lower()
    if key in _REGISTRY:
        return _REGISTRY[key]()
    if key.split("(")[0] in _NOT_PORTED:
        raise _not_ported(name)
    raise NotImplementedError(
        f"XC functional {name!r} not implemented; available: "
        f"{sorted(_REGISTRY)}")


def get_xc(expr) -> BaseXC:
    """Resolve an XC spec: BaseXC instance, name, or +/- scaled expression."""
    if isinstance(expr, BaseXC):
        return expr
    s = expr.strip().lower()
    named = _named_composites()
    if s in named:
        return named[s]()
    if s in _NOT_PORTED:
        raise _not_ported(expr)
    # terms like "0.25*hf + 0.75*gga_x_b88"; split on '+' only at paren
    # depth 0 so that an omega written as '1e+4' stays whole
    terms, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        elif ch == "+" and depth == 0:
            terms.append(s[start:i])
            start = i + 1
    terms.append(s[start:])
    out = None
    for term in terms:
        term = term.strip()
        if not term:
            continue
        m = re.match(r"^([0-9.eE+-]+)\s*\*\s*"
                     r"([a-z0-9_]+(?:\([0-9.eE+-]+\))?)$", term)
        if m:
            xc = float(m.group(1)) * get_libxc(m.group(2))
        else:
            xc = get_libxc(term)
        out = xc if out is None else out + xc
    if out is None:
        raise ValueError(f"Empty XC expression: {expr!r}")
    return out
