"""Grid density and V_xc assembly of a GGA: wrappers of the hand-written
Hopper kernels.

Replaces the TPU kernels dqc_tpu/ops/pallas_xc.py::ds_dens_gga and
::ds_vxc_gga (with its prologue build_wt). From the AO tables phi
(ng, nao) and dphi (3, ng, nao), float64:

  ds_dens_gga(ao, ao_grad, dm) -> rho[g]    = sum_ij dm[i,j] phi_i(g) phi_j(g)
                                  gdot[d,g] = 2 sum_ij dm[i,j] dphi_d,i(g) phi_j(g)
  ds_vxc_gga(ao, ao_grad, vrho, vgrad) -> raw V[i,j] = sum_g WT[i,g] phi_j(g),
      WT[i,g] = vrho[g] phi_i(g) + 2 sum_d vgrad[d,g] dphi_d,i(g)
      (quadrature weights folded into vrho, vgrad; the caller symmetrises)

Batch axis: tables (B, ng, nao), (B, 3, ng, nao) with dm (B, nao, nao), or
with vrho (B, ng), vgrad (B, 3, ng), give the members' results stacked, in
ONE launch of each kernel for the whole batch (what jax.vmap of the TPU
kernels computes): the member is a grid axis, each member keeps its own
blocks, panels and partials, and K3's fold stays per member and in order.
The launch plans spread the batch over the card's multiprocessors
(`sms // B` blocks per member). An unbatched call is the batch of one and
gives the bits it always gave. A batch's members may lie at any member
stride, 0 included, so long as each member's block is contiguous: the
kernels take each tensor's own stride(0). The members' tables of one
k-point of a batch of k-point cells, grid["ao"][:, k] of (B, nk, ng, 2 nao),
are such a view, read in place (a copy would move 200 MB per k-point at
the k-point main path's shape).

The kernels are csrc/ds_dens_gga.cu and csrc/ds_vxc_gga.cu (CUDA C++ for
sm_90a; their headers say what bounds them and how they are laid out).
None of the TPU machinery carries over: no hi/lo f32 planes, no (8,128)
padding, no masked-iota column select, no limit on nao. ds_dens_gga forms
one product C = phi dm^T on the f64 tensor cores and the four row dots of C
in its epilogue; `dens_plan` chooses its tiles, panels, ring depth, shared
memory and block count on the host. ds_vxc_gga streams the tables once by
bulk copies, forms WT in shared memory from them and the potentials, and
one product V = WT^T phi on the f64 tensor cores, one partial V per block
added in a fixed order by a second kernel; `vxc_plan` chooses its panels,
ring depth, shared memory and block count.

Dispatch: tensors on the CPU take the plain PyTorch versions
`ds_dens_reference` / `ds_vxc_reference`; CUDA tensors launch the kernel
or raise. Nothing switches the kernels off. The shared libraries are built
at first use (ops/_nvcc.py); nothing CUDA-only is touched at import.

Derivatives (`_DsDens`, `_DsVxc`: torch.autograd.Functions; the TPU
kernels had none). The two kernels are each other's transpose in their
potential and density arguments:
  - ds_dens_gga's cotangent in dm is ds_vxc_gga(ao, ao_grad, rhobar,
    gdotbar), raw and unsymmetrised (d rho / d dm_ij = phi_i phi_j and
    d gdot_d / d dm_ij = 2 dphi_d,i phi_j, the factor 2 of WT);
  - ds_vxc_gga's cotangents in (vrho, vgrad) are ds_dens_gga(ao, ao_grad,
    Vbar).
Both go through the Functions again, so every higher order works. The
cotangents of the tables phi and dphi are products of (ng, nao) tables
with nao x nao matrices in plain torch: backward contractions that no TPU
kernel computed.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _nvcc

# (pointers, ng, nao, batch, three member strides, the plan, the stream)
_DENS_SYMBOLS = {"ds_dens_gga_launch":
                 _nvcc.ptr(5) + _nvcc.ints(3) + [ctypes.c_longlong] * 3
                 + _nvcc.ints(5) + [ctypes.c_void_p]}
_VXC_SYMBOLS = {"ds_vxc_gga_launch":
                _nvcc.ptr(6) + _nvcc.ints(3) + [ctypes.c_longlong] * 3
                + _nvcc.ints(5) + [ctypes.c_void_p]}
SOURCES = {"ds_dens_gga": _nvcc.source_path("ds_dens_gga"),
           "ds_vxc_gga": _nvcc.source_path("ds_vxc_gga")}

# ds_dens_gga: grid points per tile, warps per block and the widest panel
# of dm (kBM, kWarps and kMaxPanel of the kernel: one 8-row n-tile per
# warp), the doubles of its cross-warp reduction buffer (kRed), the shared
# memory a block may opt into on an H100, and the multiprocessors of an
# H100 (one persistent block each)
D_TILE = 16
D_WARPS = 16
D_MAX_PANEL = 8 * D_WARPS
D_RED_DOUBLES = D_WARPS * 4 * D_TILE
SMEM_LIMIT = 232_448
H100_SMS = 132

# ds_vxc_gga: grid points per tile (kBK of the kernel: the K of its GEMM),
# the widest panel of V (kMaxPanel: 4 x 4 warps of 32 x 32 each), the
# doubles of one potential's span in a stage (kVSlot) and the groups of
# consecutive blocks whose partials the fold adds first (kFoldGroups)
V_POINTS = 16
V_MAX_PANEL = 128
V_POT_SLOT = V_POINTS + 2
V_FOLD_GROUPS = 8


def build(force: bool = False) -> dict:
    """Compile both kernels if their libraries are missing or stale
    (always with force=True). Returns {name: {'seconds', 'built', 'log'}}."""
    return {name: _nvcc.build(name, force=force) for name in SOURCES}


def _check_tables(ao, ao_grad, name):
    """(batch shape, ng, nao) of tables ao ([B,] ng, nao) and ao_grad ([B,]
    3, ng, nao)."""
    if ao.ndim not in (2, 3):
        raise ValueError(f"{name}: ao must be (ng, nao) or (B, ng, nao), got "
                         f"{tuple(ao.shape)}")
    lead, (ng, nao) = tuple(ao.shape[:-2]), tuple(ao.shape[-2:])
    if tuple(ao_grad.shape) != lead + (3, ng, nao):
        raise ValueError(f"{name}: ao_grad must be {lead + (3, ng, nao)}, "
                         f"got {tuple(ao_grad.shape)}")
    return lead, ng, nao


def kernel_layout(t, batched: bool) -> bool:
    """Whether the kernels read t as it lies: contiguous, or for a batch
    each member's block contiguous (t[0]) at any member stride, 0 included,
    which the launch passes as stride(0)."""
    return t[0].is_contiguous() if batched else t.is_contiguous()


def _check_common(name, tensors, batched):
    """Whether the kernel runs (a CUDA tensor; False on the CPU). On the
    card every tensor must have a layout the kernels read (kernel_layout);
    any other raises: nothing is copied."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float64:
            raise TypeError(f"{name} takes float64 tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name} has no kernel for device {dev}")
    for t in tensors:
        if not kernel_layout(t, batched):
            raise ValueError(
                f"{name} on the card needs contiguous tensors, or for a "
                "batch each member's block contiguous at any member stride; "
                f"got shape {tuple(t.shape)} with strides {t.stride()}")
    return True


def ds_dens_reference(ao, ao_grad, dm):
    """Plain PyTorch version of ds_dens_gga in the kernel's algebra: one
    product c = ao @ dm.T (c[g,i] = sum_j phi_j(g) dm[i,j]), then the row
    dots of c with phi and with each gradient table; right for any dm. A
    batch member by member (each with the bits of its unbatched call).
    Used on CPU tensors and as the oracle of the kernel on the card."""
    if ao.ndim == 3:
        outs = [ds_dens_reference(*m) for m in zip(ao, ao_grad, dm)]
        return tuple(torch.stack(o) for o in zip(*outs))
    c = ao @ dm.T
    rho = (c * ao).sum(-1)
    gdot = 2.0 * (ao_grad * c).sum(-1)
    return rho, gdot


def dens_stage_doubles(panel: int, nao: int) -> int:
    """Doubles of one ring stage of the ds_dens_gga kernel (its
    stage_doubles): D_TILE rows of the phi columns of the block (row stride
    panel + 4) and of the panel's columns of the three gradient tables, and
    of phi when there is more than one panel (row stride panel or panel + 8,
    whichever is 8 mod 16)."""
    e_stride = panel if panel % 16 == 8 else panel + 8
    e_tables = 3 if nao <= panel else 4
    return D_TILE * (panel + 4 + e_tables * e_stride)


def dens_plan(ng: int, nao: int, sms: int = H100_SMS,
              batch: int = 1) -> dict:
    """Launch plan of the ds_dens_gga kernel for `batch` members of ng
    points and nao AOs.

    dm is cut into panels of `panel` rows (a multiple of 8, at most 128) and
    column blocks of the same width; each warp keeps its 8 rows of a panel
    in registers. Three ring stages (dens_stage_doubles) where they fit,
    else two. One block per multiprocessor: `blocks` per member (sms //
    batch, at least one), no more than the member's tiles; the grid is
    blocks x batch (the layout the kernel checks)."""
    if ng <= 0 or nao <= 0 or batch <= 0:
        raise ValueError(f"dens_plan: ng = {ng}, nao = {nao} and batch = "
                         f"{batch} must be > 0")
    panel = min(D_MAX_PANEL, -(-nao // 8) * 8)
    for stages in (3, 2):
        smem = 8 * (stages * dens_stage_doubles(panel, nao) + D_RED_DOUBLES)
        if smem <= SMEM_LIMIT:
            break
    else:   # unreachable while D_MAX_PANEL and D_TILE stay as they are
        raise ValueError(f"dens_plan: no ring fits in {SMEM_LIMIT} bytes")
    tiles = -(-ng // D_TILE)
    return {"tile_points": D_TILE, "panel": panel,
            "panels": -(-nao // panel), "stages": stages,
            "smem_bytes": smem, "blocks": max(1, min(tiles, sms // batch)),
            "tiles": tiles, "batch": batch}


@functools.lru_cache(maxsize=64)
def _dens_launch_plan(ng: int, nao: int, batch: int,
                      device_index: int) -> tuple:
    """(tile_points, panel, stages, smem_bytes, blocks) of dens_plan for
    the card `device_index`, kept per shape: the SCF calls the kernel at
    one shape every iteration."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    p = dens_plan(ng, nao, sms, batch)
    return (p["tile_points"], p["panel"], p["stages"], p["smem_bytes"],
            p["blocks"])


def ds_vxc_reference(ao, ao_grad, vrho, vgrad):
    """Plain PyTorch version of ds_vxc_gga: the GGA terms of
    xc/integrate._vxc_assemble (raw, unsymmetrised); a batch member by
    member."""
    if ao.ndim == 3:
        return torch.stack([ds_vxc_reference(*m)
                            for m in zip(ao, ao_grad, vrho, vgrad)])
    v = torch.einsum("gi,g,gj->ij", ao, vrho, ao)
    return v + 2.0 * torch.einsum("dgi,dg,gj->ij", ao_grad, vgrad, ao)


def ds_dens_gga(ao, ao_grad, dm):
    """(rho (ng,), gdot (3, ng)) from ao (ng, nao), ao_grad (3, ng, nao) and
    dm (nao, nao), float64 (dm need not be symmetric); or of a batch, ao
    (B, ng, nao), ao_grad (B, 3, ng, nao), dm (B, nao, nao) -> rho (B, ng),
    gdot (B, 3, ng), one launch.

    CPU tensors: the plain version. CUDA tensors: the kernel; every tensor
    contiguous, or for a batch each member's block (any member stride).
    Differentiable on both. Raises on anything the kernel does not take
    and on a failed build or launch."""
    lead, ng, nao = _check_tables(ao, ao_grad, "ds_dens_gga")
    if tuple(dm.shape) != lead + (nao, nao):
        raise ValueError(f"ds_dens_gga: dm must be {lead + (nao, nao)}, got "
                         f"{tuple(dm.shape)}")
    return _DsDens.apply(ao, ao_grad, dm)


def _dens_forward(ao, ao_grad, dm):
    lead, (ng, nao) = tuple(ao.shape[:-2]), tuple(ao.shape[-2:])
    if not _check_common("ds_dens_gga", (ao, ao_grad, dm), bool(lead)):
        return ds_dens_reference(ao, ao_grad, dm)
    batch = lead[0] if lead else 1
    # member strides in doubles (unused by a batch of one)
    strides = ((ao.stride(0), ao_grad.stride(0), dm.stride(0)) if lead
               else (ng * nao, 3 * ng * nao, nao * nao))
    lib = _nvcc.load("ds_dens_gga", _DENS_SYMBOLS)
    plan = _dens_launch_plan(ng, nao, batch, ao.device.index)
    with torch.cuda.device(ao.device):
        rho = torch.empty(lead + (ng,), dtype=ao.dtype, device=ao.device)
        gdot = torch.empty(lead + (3, ng), dtype=ao.dtype, device=ao.device)
        stream = torch.cuda.current_stream(ao.device).cuda_stream
        err = lib.ds_dens_gga_launch(
            ao.data_ptr(), ao_grad.data_ptr(), dm.data_ptr(), rho.data_ptr(),
            gdot.data_ptr(), ng, nao, batch, *strides, *plan, stream)
    if err != 0:
        raise RuntimeError(f"ds_dens_gga kernel launch failed: cudaError "
                           f"{err} (ng={ng}, nao={nao}, batch={batch}, "
                           f"plan={plan})")
    ds_dens_gga.launches += 1
    return rho, gdot


ds_dens_gga.launches = 0   # launches of the CUDA kernel (never the plain version)


def vxc_smem_bytes(nao: int, panel: int, panels: int, stages: int) -> int:
    """Dynamic shared memory of the ds_vxc_gga kernel (its smem_bytes_of):
    the operands WT and phi, V_POINTS rows of panel + 4 doubles each; the
    ring of stages, each with one slot per table (phi, dphi_x,y,z of panel
    p, and phi of panel q when V has more than one panel: one span of
    V_POINTS rows and its lead with one panel, else V_POINTS row segments
    of panel + 2 doubles) and 4 potential spans of V_POT_SLOT doubles; one
    8-byte mbarrier per stage."""
    if panels == 1:
        tables, slot = 4, V_POINTS * nao + 2
    else:
        tables, slot = 5, V_POINTS * (panel + 2)
    stage = tables * slot + 4 * V_POT_SLOT
    return 8 * (2 * V_POINTS * (panel + 4) + stages * stage) + 8 * stages


def vxc_plan(ng: int, nao: int, sms: int = H100_SMS,
             batch: int = 1) -> dict:
    """Launch plan of the ds_vxc_gga kernel for `batch` members of ng
    points and nao AOs.

    V is cut into `panels` x `panels` sub-blocks of `panel` rows and
    columns (a multiple of 16, at most V_MAX_PANEL; as few panels as that
    allows, as even as 16 allows), one for nao <= 128. Three ring stages
    (vxc_smem_bytes) where they fit, else two. One block per multiprocessor
    and no more blocks than tiles; block b takes the tiles
    [b * tiles // blocks, (b + 1) * tiles // blocks) and writes one partial
    V (the layout the kernel checks)."""
    if ng <= 0 or nao <= 0 or sms <= 0:
        raise ValueError(f"vxc_plan: ng = {ng}, nao = {nao} and sms = {sms} "
                         "must be > 0")
    n = -(-nao // V_MAX_PANEL)
    panel = -(-(-(-nao // n)) // 16) * 16
    panels = -(-nao // panel)
    for stages in (3, 2):
        smem = vxc_smem_bytes(nao, panel, panels, stages)
        if smem <= SMEM_LIMIT:
            break
    else:   # unreachable while V_MAX_PANEL and V_POINTS stay as they are
        raise ValueError(f"vxc_plan: no ring fits in {SMEM_LIMIT} bytes")
    tiles = -(-ng // V_POINTS)
    return {"tile_points": V_POINTS, "panel": panel, "panels": panels,
            "sub_blocks": panels * panels, "stages": stages,
            "smem_bytes": smem, "blocks": max(1, min(tiles, sms // batch)),
            "tiles": tiles, "batch": batch}


@functools.lru_cache(maxsize=64)
def _vxc_launch_plan(ng: int, nao: int, batch: int,
                     device_index: int) -> tuple:
    """(tile_points, panel, stages, smem_bytes, blocks) of vxc_plan for the
    card `device_index`, kept per shape like _dens_launch_plan."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    p = vxc_plan(ng, nao, sms, batch)
    return (p["tile_points"], p["panel"], p["stages"], p["smem_bytes"],
            p["blocks"])


def ds_vxc_gga(ao, ao_grad, vrho, vgrad):
    """Raw V (nao, nao) from ao (ng, nao), ao_grad (3, ng, nao), vrho (ng,)
    and vgrad (3, ng), float64; or of a batch, tables (B, ng, nao), (B, 3,
    ng, nao) and potentials (B, ng), (B, 3, ng) -> V (B, nao, nao), one
    launch.

    CPU tensors: the plain version. CUDA tensors: the kernel; every tensor
    contiguous, or for a batch each member's block (any member stride;
    vgrad's three times vrho's). Differentiable on both. Raises on
    anything the kernel does not take and on a failed build or launch."""
    lead, ng, nao = _check_tables(ao, ao_grad, "ds_vxc_gga")
    if (tuple(vrho.shape) != lead + (ng,)
            or tuple(vgrad.shape) != lead + (3, ng)):
        raise ValueError(f"ds_vxc_gga: vrho must be {lead + (ng,)} and vgrad "
                         f"{lead + (3, ng)}, got {tuple(vrho.shape)} and "
                         f"{tuple(vgrad.shape)}")
    return _DsVxc.apply(ao, ao_grad, vrho, vgrad)


def _vxc_forward(ao, ao_grad, vrho, vgrad):
    lead, (ng, nao) = tuple(ao.shape[:-2]), tuple(ao.shape[-2:])
    if not _check_common("ds_vxc_gga", (ao, ao_grad, vrho, vgrad),
                         bool(lead)):
        return ds_vxc_reference(ao, ao_grad, vrho, vgrad)
    batch = lead[0] if lead else 1
    strides = (ng * nao, 3 * ng * nao, ng)
    if lead:
        # the kernel reads vgrad at 3 x the member stride of vrho
        if vgrad.stride(0) != 3 * vrho.stride(0):
            raise ValueError(
                "ds_vxc_gga on the card reads vgrad at three times the "
                f"member stride of vrho; got {vgrad.stride(0)} and "
                f"{vrho.stride(0)}")
        strides = (ao.stride(0), ao_grad.stride(0), vrho.stride(0))
    lib = _nvcc.load("ds_vxc_gga", _VXC_SYMBOLS)
    plan = _vxc_launch_plan(ng, nao, batch, ao.device.index)
    with torch.cuda.device(ao.device):
        v = torch.empty(lead + (nao, nao), dtype=ao.dtype, device=ao.device)
        # one partial V per block and member, added in a fixed order by the
        # fold
        part = torch.empty((batch, plan[-1], nao, nao), dtype=ao.dtype,
                           device=ao.device)
        stream = torch.cuda.current_stream(ao.device).cuda_stream
        err = lib.ds_vxc_gga_launch(ao.data_ptr(), ao_grad.data_ptr(),
                                    vrho.data_ptr(), vgrad.data_ptr(),
                                    v.data_ptr(), part.data_ptr(), ng, nao,
                                    batch, *strides, *plan, stream)
    if err != 0:
        raise RuntimeError(f"ds_vxc_gga kernel launch failed: cudaError "
                           f"{err} (ng={ng}, nao={nao}, batch={batch}, "
                           f"plan={plan})")
    ds_vxc_gga.launches += 1
    return v


ds_vxc_gga.launches = 0   # launches of the CUDA kernel (never the plain version)


class _DsDens(torch.autograd.Function):
    """rho, gdot = ds_dens_gga(ao, ao_grad, dm) with its cotangents."""

    @staticmethod
    def forward(ctx, ao, ao_grad, dm):
        ctx.save_for_backward(ao, ao_grad, dm)
        return _dens_forward(ao, ao_grad, dm)

    @staticmethod
    def backward(ctx, rho_bar, gdot_bar):
        ao, ag, dm = ctx.saved_tensors
        need_ao, need_ag, need_dm = ctx.needs_input_grad
        ao_bar = ag_bar = dm_bar = None
        if need_dm:
            dm_bar = _DsVxc.apply(ao, ag, rho_bar.contiguous(),
                                  gdot_bar.contiguous())
        if need_ao or need_ag:
            c = ao @ dm.mT                     # c[g,p] = sum_j dm[p,j] phi_j
        if need_ao:
            # rho = <c, phi>: both factors of phi; gdot_d = 2 <c, dphi_d>
            ao_bar = rho_bar[..., :, None] * (c + ao @ dm) + 2.0 * (
                (gdot_bar[..., :, :, None] * ag).sum(-3) @ dm)
        if need_ag:
            ag_bar = 2.0 * gdot_bar[..., :, :, None] * c[..., None, :, :]
        return ao_bar, ag_bar, dm_bar


class _DsVxc(torch.autograd.Function):
    """V = ds_vxc_gga(ao, ao_grad, vrho, vgrad) with its cotangents."""

    @staticmethod
    def forward(ctx, ao, ao_grad, vrho, vgrad):
        ctx.save_for_backward(ao, ao_grad, vrho, vgrad)
        return _vxc_forward(ao, ao_grad, vrho, vgrad)

    @staticmethod
    def backward(ctx, v_bar):
        ao, ag, vrho, vgrad = ctx.saved_tensors
        need_ao, need_ag, need_vr, need_vg = ctx.needs_input_grad
        ao_bar = ag_bar = vr_bar = vg_bar = None
        v_bar = v_bar.contiguous()
        if need_vr or need_vg:
            vr_bar, vg_bar = _DsDens.apply(ao, ag, v_bar)
        if need_ao or need_ag:
            c = ao @ v_bar.mT                  # c[g,p] = sum_j Vbar[p,j] phi_j
        if need_ao:
            # V = WT^T phi: phi enters WT (vrho phi_i) and the right factor
            ao_bar = vrho[..., :, None] * (c + ao @ v_bar) + 2.0 * (
                (vgrad[..., :, :, None] * ag).sum(-3) @ v_bar)
        if need_ag:
            ag_bar = 2.0 * vgrad[..., :, :, None] * c[..., None, :, :]
        return ao_bar, ag_bar, vr_bar, vg_bar
