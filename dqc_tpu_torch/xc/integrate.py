"""Grid integration of XC: densities on the grid, E_xc and V_xc
(counterpart of dqc_tpu/xc/integrate.py).

V_xc comes from the pointwise adjoints: autograd runs only through the
functional chain, from the densities at the grid points to sum_g dvol e(g),
and the matrix is assembled from those adjoints in closed form
(`_vxc_assemble`). In the SCF loop (no_grad) the (ng, nao) table products
never enter an autograd graph; when V_xc itself is differentiated (the
implicit derivatives of scf/fixed_point.py) the adjoints keep their graph
and the kernels' own derivative rules carry it. V_xc is the symmetrised
derivative of E_xc in dm.

The density and V_xc of a GGA go through ops/hopper_xc.ds_dens_gga and
ds_vxc_gga, whose wrappers choose the device: the kernels K2 and K3 on a
CUDA tensor, their plain versions on a CPU tensor; both are differentiable
(ops/hopper_xc.py). An LDA's density and matrix, and the
lapl/tau terms of the MGGA family, are plain torch on either device.
vxc_matrix_ad is the brute-force oracle: autograd of exc_energy.

A batch of geometries (parallel/batch.py) stacks the tables, (B, ng, nao)
and (B, 3, ng, nao), with dm (B, [2,] nao, nao): densities come out (B,
ng), energies (B,), V_xc (B, [2,] nao, nao), and K2/K3 take the batch in
one launch each.

Grid tables are built from the atom positions (Becke weights and point
coordinates move with the atoms). On the CPU the grid axis is cut into
chunks beyond XC_CHUNK_ELEMS; on the card the tables are whole already and
the kernels take any number of points, so the grid is not cut.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid.becke import becke_weights
from ..ops import hopper_xc
from ..ops.aoeval import eval_ao
from ..ops.chunks import map_blocks, map_reduce_blocks

# AO tables are evaluated in chunks of this many points during set-up
# (bounds the peak memory of the polynomial machinery); the tables persist
AO_EVAL_CHUNK = 16384
# grid points with a density at or below this contribute zero energy and
# zero gradient (double-where screen)
DENS_THRESHOLD = 1e-12
# elements budget of one (chunk, nao) intermediate of the plain versions on
# the CPU; the grid axis is cut into chunks only beyond it
XC_CHUNK_ELEMS = 50_000_000


def _deriv_of_family(family: int) -> int:
    return 0 if family <= 1 else (1 if family <= 2 else 2)


def _chunk_size(nao: int) -> int:
    return max(65536, XC_CHUNK_ELEMS // max(nao, 1))


def _default_chunk(grid_theta) -> int:
    """The whole grid on the card or for a batch of tables, else chunks."""
    ao = grid_theta["ao"]
    if ao.is_cuda or ao.ndim == 3:
        return ao.shape[-2]
    return _chunk_size(ao.shape[-1])


def setup_grid_theta(meta, params, grid, family: int = 1):
    """GridSpec -> grid tables on the device of params: coords (ng, 3),
    dvol (ng,), ao (ng, nao), ao_grad (3, ng, nao) for GGA, ao_lapl
    (ng, nao) for MGGA, and the family. The AO tables depend only on the
    basis parameters and are computed once, in chunks of AO_EVAL_CHUNK
    points."""
    atompos = params["atompos"]
    dev, dt = atompos.device, atompos.dtype
    atom_idx = torch.as_tensor(grid.atom_idx.astype(np.int64), device=dev)
    ratom = torch.as_tensor(grid.ratom, dtype=dt, device=dev)
    dirs = torch.as_tensor(grid.dirs, dtype=dt, device=dev)
    coords = atompos[atom_idx] + ratom[:, None] * dirs
    w_becke = becke_weights(coords, atom_idx, atompos,
                            torch.as_tensor(grid.atom_radii, dtype=dt,
                                            device=dev))
    dvol = torch.as_tensor(grid.w0, dtype=dt, device=dev) * w_becke
    deriv = _deriv_of_family(family)
    ng = coords.shape[0]
    out = {"coords": coords, "dvol": dvol, "family": family}
    keys = ["ao", "ao_grad", "ao_lapl"][:deriv + 1]
    for key in keys:
        def one(args, key=key):
            return eval_ao(meta, params, args["c"], deriv=deriv)[key]
        # each table is evaluated on its own pass over the chunks so that
        # only one of them is ever concatenated at a time
        tab = map_blocks(one, {"c": coords}, ng, AO_EVAL_CHUNK)
        if key == "ao_grad":
            # (3, ng, nao): the layout the kernels read
            tab = tab.permute(1, 0, 2).contiguous()
        out[key] = tab
    return out


def vext_matrix(meta, params, grid, vext):
    """V_ext[i,j] = sum_g vext[g] dvol[g] phi_i(g) phi_j(g) of a potential
    tabulated on the molecule's grid (ng,), added to hcore (the JAX
    package's vext_matrix, an einsum outside any kernel there too).
    Differentiable in vext, the basis parameters and the atom positions
    (the grid moves with the atoms)."""
    tabs = setup_grid_theta(meta, params, grid, family=1)
    ao = tabs["ao"]
    w = torch.as_tensor(vext, dtype=ao.dtype, device=ao.device) * tabs["dvol"]
    return ao.T @ (w[:, None] * ao)


def density_from_tables(tabs, dm, family: int, polarized: bool):
    """Densities at the grid points from the AO tables and dm. 'grad' is
    (3, ng); 'lapl' and 'tau' for the MGGA family. rho and grad of the GGA
    families come from hopper_xc.ds_dens_gga (K2 on the card)."""
    deriv = _deriv_of_family(family)
    ao = tabs["ao"]
    ag = tabs.get("ao_grad")   # (3, ng, nao)

    def dens_of(dmi):
        if deriv == 0:
            return {"rho": torch.einsum("...gi,...gi->...g", ao @ dmi, ao)}
        # the tables as they are: a batch's member views are read in place
        rho, gdot = hopper_xc.ds_dens_gga(ao, ag, dmi.contiguous())
        out = {"rho": rho, "grad": gdot}
        if deriv >= 2:
            gb = torch.einsum("...dgi,...ij->...dgj", ag, dmi)
            t1 = torch.einsum("...gi,...gi->...g", tabs["ao_lapl"] @ dmi, ao)
            gg = torch.einsum("...dgi,...dgi->...g", gb, ag)
            out["lapl"] = 2.0 * t1 + 2.0 * gg
            out["tau"] = 0.5 * gg
        return out

    if polarized:
        return {"u": dens_of(dm.select(-3, 0)),
                "d": dens_of(dm.select(-3, 1))}
    return dens_of(dm)


def _screen(mask, x, fill=1.0):
    return torch.where(mask, x, torch.full_like(x, fill))


def _edens_at(xc, dens, polarized: bool, xcparams=None):
    """Energy density at every grid point, with the double-where screen:
    points at or below DENS_THRESHOLD get harmless inputs and a zero
    result, so their gradient is zero and never NaN. A parameterised
    functional (xc/custom.CustomXC) is called through apply_pol/apply_unpol
    with the xc_params dict of theta."""
    fam = xc.family
    if polarized:
        du, dd = dens["u"], dens["d"]
        mask = (du["rho"] + dd["rho"]) > DENS_THRESHOLD
        kw = {}
        if fam >= 2:
            kw["sigma_uu"] = _screen(mask,
                                     torch.sum(du["grad"] ** 2, dim=-2))
            kw["sigma_ud"] = _screen(
                mask, torch.sum(du["grad"] * dd["grad"], dim=-2))
            kw["sigma_dd"] = _screen(mask,
                                     torch.sum(dd["grad"] ** 2, dim=-2))
        if fam >= 4:
            kw.update(lapl_u=_screen(mask, du["lapl"]),
                      lapl_d=_screen(mask, dd["lapl"]),
                      tau_u=_screen(mask, du["tau"]),
                      tau_d=_screen(mask, dd["tau"]))
        ru = _screen(mask, du["rho"])
        rd = _screen(mask, dd["rho"])
        if hasattr(xc, "apply_pol"):
            e = xc.apply_pol(xcparams, ru, rd, **kw)
        else:
            e = xc.edens_pol(ru, rd, **kw)
    else:
        mask = dens["rho"] > DENS_THRESHOLD
        kw = {}
        if fam >= 2:
            kw["sigma"] = _screen(mask, torch.sum(dens["grad"] ** 2, dim=-2))
        if fam >= 4:
            kw.update(lapl=_screen(mask, dens["lapl"]),
                      tau=_screen(mask, dens["tau"]))
        r = _screen(mask, dens["rho"])
        if hasattr(xc, "apply_unpol"):
            e = xc.apply_unpol(xcparams, r, **kw)
        else:
            e = xc.edens_unpol(r, **kw)
    return torch.where(mask, e, torch.zeros_like(e))


def _vxc_assemble(vbar, tabs):
    """Closed-form V_xc from the pointwise adjoints vbar = d(E_xc)/d(rho,
    grad, lapl, tau), dvol already folded in. Raw (unsymmetrised). The rho
    and grad terms of the GGA families come from hopper_xc.ds_vxc_gga (K3
    on the card)."""
    ao = tabs["ao"]
    ag = tabs.get("ao_grad")   # (3, ng, nao)
    vg = vbar.get("grad")
    if vg is None:
        V = torch.einsum("...gi,...g,...gj->...ij", ao, vbar["rho"], ao)
    else:
        # d(grad rho_d)/d dm_ij = 2 ag_dgi ao_gj (gdot = 2 <gb, ao>)
        V = hopper_xc.ds_vxc_gga(ao, ag, vbar["rho"].contiguous(),
                                 vg.contiguous())
    vl = vbar.get("lapl")
    if vl is not None:
        # lapl = 2 t1 + 2 gg, t1 = <L dm, ao>, gg = <ag dm, ag>
        V = V + 2.0 * torch.einsum("...gi,...g,...gj->...ij",
                                   tabs["ao_lapl"], vl, ao)
        V = V + 2.0 * torch.einsum("...dgi,...g,...dgj->...ij", ag, vl, ag)
    vt = vbar.get("tau")
    if vt is not None:
        V = V + 0.5 * torch.einsum("...dgi,...g,...dgj->...ij", ag, vt, ag)
    return V


def _detached_leaves(d):
    return {k: _detached_leaves(v) if isinstance(v, dict)
            else v.detach().requires_grad_(True) for k, v in d.items()}


def _flat(d):
    return [x for v in d.values()
            for x in (_flat(v) if isinstance(v, dict) else [v])]


def _unflat(d, it):
    return {k: _unflat(v, it) if isinstance(v, dict) else next(it)
            for k, v in d.items()}


def _detached(x):
    """x (nested dicts, lists, tensors) with every tensor detached."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, dict):
        return {k: _detached(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_detached(v) for v in x)
    return x


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _pointwise_adjoints(xc, dens, w, polarized, xcparams):
    """(E_xc, vbar): the energy and its derivatives in the densities at the
    grid points, by autograd through the functional chain only (as
    jax.value_and_grad(esum)(dens) in the JAX package).

    Where something upstream is differentiated (grad enabled and a density,
    the weights or an xcparams tensor requiring grad), the graph is kept:
    vbar is taken with create_graph=True on the densities as they are, so
    V_xc carries the second derivative of the functional (f_xc) in dm, in
    the AO tables and in the weights, and E_xc its first. Otherwise (the SCF
    loop runs under no_grad) the densities, the weights and the xc_params
    of a CustomXC are detached first and nothing upstream of them is
    differentiated. Either way the double-where screen of _edens_at gives
    dead lanes harmless inputs, so no derivative order sees a NaN."""
    flat = _flat(dens)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in flat + [w] + _tensors(xcparams))
    with torch.enable_grad():
        if keep:
            leaves = _unflat(dens, iter(
                x if x.requires_grad else x.detach().requires_grad_(True)
                for x in flat))
        else:
            leaves, w = _detached_leaves(dens), w.detach()
            xcparams = _detached(xcparams)
        # per member of a batch: the sum over the grid axis
        exc = torch.sum(_edens_at(xc, leaves, polarized, xcparams) * w,
                        dim=-1)
        flat = _flat(leaves)
        grads = torch.autograd.grad(exc.sum(), flat, allow_unused=True,
                                    create_graph=keep)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(flat, grads)]
    return (exc if keep else exc.detach()), _unflat(leaves, iter(grads))


def _exc_vxc_tabs(xc, dm, tabs, polarized: bool, xcparams):
    """One-pass (E_xc, raw V_xc) over one set of tables."""
    dens = density_from_tables(tabs, dm, xc.family, polarized)
    exc, vbar = _pointwise_adjoints(xc, dens, tabs["dvol"], polarized,
                                    xcparams)
    if polarized:
        V = torch.stack([_vxc_assemble(vbar["u"], tabs),
                         _vxc_assemble(vbar["d"], tabs)], dim=-3)
    else:
        V = _vxc_assemble(vbar, tabs)
    return exc, V


def _tab_args(grid_theta):
    keys = [k for k in ("ao", "ao_grad", "ao_lapl", "dvol")
            if k in grid_theta]
    return {k: grid_theta[k] for k in keys}, {"ao_grad": 1}


def exc_energy(xc, dm, grid_theta, polarized: bool, xcparams=None,
               chunk: int = None):
    """E_xc = sum_g dvol_g e(r_g) over the precomputed AO tables ((B,) for
    a batch); differentiable in dm."""
    ng = grid_theta["dvol"].shape[-1]

    def body(tabs):
        dens = density_from_tables(tabs, dm, xc.family, polarized)
        return torch.sum(_edens_at(xc, dens, polarized, xcparams)
                         * tabs["dvol"], dim=-1)
    args, axes = _tab_args(grid_theta)
    return map_reduce_blocks(body, args, ng,
                             chunk or _default_chunk(grid_theta), axes)


def exc_vxc(xc, dm, grid_theta, polarized: bool, xcparams=None,
            chunk: int = None):
    """(E_xc, V_xc), V_xc symmetrised: autograd runs only through the
    pointwise functional chain, never through the (ng, nao) table
    products."""
    ng = grid_theta["dvol"].shape[-1]
    args, axes = _tab_args(grid_theta)
    exc, V = map_reduce_blocks(
        lambda tabs: _exc_vxc_tabs(xc, dm, tabs, polarized, xcparams),
        args, ng, chunk or _default_chunk(grid_theta), axes)
    return exc, 0.5 * (V + V.transpose(-1, -2))


def vxc_matrix(xc, dm, grid_theta, polarized: bool, xcparams=None):
    """V_xc = d E_xc / d dm, symmetrised (E_xc(dm) as written represents
    the density only for a symmetric dm, so the raw gradient carries a
    spurious antisymmetric part). Computed by exc_vxc; vxc_matrix_ad is
    the brute-force oracle it is tested against."""
    return exc_vxc(xc, dm, grid_theta, polarized, xcparams)[1]


def vxc_matrix_ad(xc, dm, grid_theta, polarized: bool, xcparams=None):
    """Brute-force V_xc = autograd of exc_energy in dm: the test oracle of
    exc_vxc."""
    with torch.enable_grad():
        d = dm.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            exc_energy(xc, d, grid_theta, polarized, xcparams), d)
    return 0.5 * (g + g.transpose(-1, -2))
