"""XC resolver: libxc-style names and expressions -> torch functionals
(counterpart of dqc_tpu/xc/getxc.py).

Strings like "lda_x", "gga_x_pbe+gga_c_pbe", "0.25*hf+0.75*gga_x_b88" and
the named composites (b3lyp, pbe0, cam-b3lyp, scan, ...); the meta-GGA
pieces (mgga_[xc]_scan, mgga_[xc]_tpss) and the range-separated ones,
written name(omega): lr_hf(0.33), sr_hf(0.11), lda_x_erf(0.3),
gga_x_ityh_b88(0.33).
"""
from __future__ import annotations

import re

from .base import BaseXC, HFExchangeXC, LRHFExchangeXC
from .gga import (GGA_C_LYP, GGA_C_PBE, GGA_C_PBE_SOL, GGA_X_B88,
                  GGA_X_ITYH_B88, GGA_X_OPTX, GGA_X_PBE, GGA_X_PBE_SOL,
                  GGA_X_REVPBE, GGA_X_RPBE)
from .lda import LDA_C_PW, LDA_C_PZ, LDA_C_VWN3, LDA_C_VWN5, LDA_X, LDA_X_ERF
from .mgga import MGGA_C_SCAN, MGGA_C_TPSS, MGGA_X_SCAN, MGGA_X_TPSS

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
    "mgga_x_scan": MGGA_X_SCAN,
    "mgga_c_scan": MGGA_C_SCAN,
    "mgga_x_tpss": MGGA_X_TPSS,
    "mgga_c_tpss": MGGA_C_TPSS,
}

# functionals of the range-separation parameter, written name(omega):
# long-range exact exchange (erf kernel), short-range exact exchange
# (hf - lr_hf), short-range Slater exchange, short-range B88 (ITYH)
_OMEGA_REGISTRY = {
    "lr_hf": LRHFExchangeXC,
    "sr_hf": lambda w: HFExchangeXC() + (-1.0) * LRHFExchangeXC(w),
    "lda_x_erf": LDA_X_ERF,
    "gga_x_ityh_b88": GGA_X_ITYH_B88,
}


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
        # CAM-B3LYP (Yanai, Tew, Handy CPL 393, 51 (2004); libxc
        # hyb_gga_xc_cam_b3lyp): exact exchange alpha + beta erf(omega r12)
        # with alpha = 0.19, beta = 0.46, omega = 0.33; DFT exchange
        # (1 - alpha - beta) B88 + beta SR-B88; 0.19 VWN5 + 0.81 LYP
        "camb3lyp": lambda: (0.19 * HFExchangeXC()
                             + 0.46 * LRHFExchangeXC(0.33)
                             + 0.35 * GGA_X_B88()
                             + 0.46 * GGA_X_ITYH_B88(0.33)
                             + 0.19 * LDA_C_VWN5() + 0.81 * GGA_C_LYP()),
        "cam-b3lyp": lambda: _named_composites()["camb3lyp"](),
        # LC-BLYP (libxc hyb_gga_xc_lc_blyp, omega = 0.30): 100 % long-range
        # exact exchange + SR-B88 + LYP
        "lc-blyp": lambda: (LRHFExchangeXC(0.30)
                            + GGA_X_ITYH_B88(0.30) + GGA_C_LYP()),
        "lc_blyp": lambda: _named_composites()["lc-blyp"](),
        "svwn": lambda: LDA_X() + LDA_C_VWN5(),
        "scan": lambda: MGGA_X_SCAN() + MGGA_C_SCAN(),
        "tpss": lambda: MGGA_X_TPSS() + MGGA_C_TPSS(),
        # meta-GGA hybrids (libxc hyb_mgga_xc_tpssh, scan0): 10 % and 25 %
        # exact exchange on TPSS and SCAN
        "tpssh": lambda: (0.10 * HFExchangeXC() + 0.90 * MGGA_X_TPSS()
                          + MGGA_C_TPSS()),
        "scan0": lambda: (0.25 * HFExchangeXC() + 0.75 * MGGA_X_SCAN()
                          + MGGA_C_SCAN()),
        "lda": lambda: LDA_X() + LDA_C_PW(),
    }


def get_libxc(name: str) -> BaseXC:
    key = name.strip().lower()
    if key in _REGISTRY:
        return _REGISTRY[key]()
    m = re.match(r"^([a-z0-9_]+)\(([0-9.eE+-]+)\)$", key)
    if m and m.group(1) in _OMEGA_REGISTRY:
        try:
            omega = float(m.group(2))
        except ValueError:
            omega = None   # a malformed omega such as '0.3.3'
        if omega is not None:
            return _OMEGA_REGISTRY[m.group(1)](omega)
    raise NotImplementedError(
        f"XC functional {name!r} not implemented; available: "
        f"{sorted(_REGISTRY)} + {sorted(_OMEGA_REGISTRY)} (of omega, e.g. "
        "'lr_hf(0.33)')")


def get_xc(expr) -> BaseXC:
    """Resolve an XC spec: BaseXC instance, name, or +/- scaled expression."""
    if isinstance(expr, BaseXC):
        return expr
    s = expr.strip().lower()
    named = _named_composites()
    if s in named:
        return named[s]()
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
