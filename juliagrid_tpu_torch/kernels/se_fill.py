"""K3 ``se_fill``: AC state-estimation measurement functions and Jacobian.

One launch computes, for B >= 1 scenarios of one measurement set, what
``juliagrid_tpu/estimation/acse.py`` computes in ``h_entries`` (:463) and
``build_h`` (:549) with the entry masks of ``gn_increment`` (:639-642): the
model values h(x) times each row's status, the residuals ``mean - h``, and
optionally the dense measurement Jacobian H ``[B, m, 2n]`` with inactive
rows zeroed and the slack column masked. The CUDA source, its mapping and
what bounds it are described in ``csrc/se_fill.cu``.

The kernel reads a per-row descriptor table (``SeFillTable``) that
``se_fill_table`` builds once on the host from the row groups of an
``SeArrays``. ``se_fill`` dispatches on the device of its tensors: a CUDA
tensor goes to the kernel (and the call raises if the kernel does not build
or launch), a CPU tensor to ``se_fill_ref``, the plain PyTorch
transcription of the jnp code. ``se_fill.launches`` counts kernel launches.

``se_fill_routed`` is K3's routed mode for the BBD estimator
(``estimation/acse_bbd.py``): one state, and instead of the dense H one
``[mr, 2ni + 2lb]`` matrix per block of the partition (its rows, its
interior columns, its local border columns), scaled by W½, written through
the row and column maps of an ``SeRoute``. It dispatches the same way, to
``se_fill_routed_ref`` on the CPU, and counts its own launches in
``se_fill_routed.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.equations import BRANCH_GROUPS
from . import _build

#: descriptor type codes: the measurement type codes of ``compile_se_arrays``
#: with the PMU magnitude row (12) folded into the voltmeter row (1)
VM, VA, RE_V, IM_V, P_INJ, Q_INJ = 1, 13, 16, 17, 6, 9


class SeFillTable(NamedTuple):
    """K3's per-row descriptor table (structure of arrays, one column per
    measurement row)."""

    idx: torch.Tensor   # i32[3, m]: type code, bus or from-bus, to-bus (-1)
    coef: torch.Tensor  # f64[5, m]: PiModel a, b, c, d and shift angle phi


class SeRoute(NamedTuple):
    """Where K3's routed mode writes, and the entry routing of the JAX
    package's per-block H (``SeBbdArrays.hi_*``/``hb_*``) that its plain
    version scatters through."""

    row_block: torch.Tensor  # i32[m] block of each measurement row
    row_slot: torch.Tensor   # i32[m] row slot inside its block
    colmap: torch.Tensor     # i32[k, n] angle column of bus j in block b
    ent_rows: torch.Tensor   # i64[E] measurement row of each H entry
    hi_sel: torch.Tensor     # i64 entries on interior columns ...
    hi_blk: torch.Tensor
    hi_row: torch.Tensor
    hi_col: torch.Tensor
    hb_sel: torch.Tensor     # ... and on local border columns
    hb_blk: torch.Tensor
    hb_row: torch.Tensor
    hb_col: torch.Tensor
    mask_int: torch.Tensor   # f64[k, 2ni] 0 at the slack angle and pads
    mask_lb: torch.Tensor    # f64[k, 2lb] the border mask in local slots
    mr: int
    ni: int
    lb: int


class SeFill(NamedTuple):
    """K3 outputs; every tensor has the leading scenario axis B."""

    h: torch.Tensor    # f64[B, m] model values times row status
    r: torch.Tensor    # f64[B, m] residuals mean - h
    jac: Optional[torch.Tensor]  # f64[B, m, 2n] masked Jacobian, or None


def se_fill_table(host) -> tuple[np.ndarray, np.ndarray]:
    """Numpy ``(idx, coef)`` of the descriptor table from the row groups of
    an ``SeArrays`` whose fields are numpy arrays (the port's host mirror,
    or the JAX package's). Raises unless every row is in exactly one group
    and every branch row joins two different buses — the guarantees that
    give each element of H one writer."""
    m = len(host.mean)
    idx = np.full((3, m), -1, dtype=np.int32)
    coef = np.zeros((5, m), dtype=np.float64)
    seen = np.zeros(m, dtype=np.int64)

    def put(rows, code, f, t=None, co=None):
        rows = np.asarray(rows, dtype=np.int64)
        np.add.at(seen, rows, 1)
        idx[0, rows] = code
        idx[1, rows] = f
        if t is not None:
            idx[2, rows] = t
            coef[:, rows] = co

    put(host.vm_rows, VM, host.vm_bus)
    put(host.va_rows, VA, host.va_bus)
    put(host.rev_rows, RE_V, host.rev_bus)
    put(host.imv_rows, IM_V, host.imv_bus)
    for (code, _, _), grp in zip(BRANCH_GROUPS, host.branch):
        f, t = np.asarray(grp.f), np.asarray(grp.t)
        if np.any(f == t):
            raise ValueError(f"a branch row of type {code} joins a bus to "
                             "itself; K3 needs two different buses")
        put(grp.rows, code, f, t,
            np.stack([np.asarray(x, dtype=np.float64)
                      for x in (grp.a, grp.b, grp.c, grp.d, grp.phi)]))
    put(host.p_rows, P_INJ, host.p_bus)
    put(host.q_rows, Q_INJ, host.q_bus)
    if np.any(seen != 1):
        raise ValueError("every measurement row must be in exactly one row "
                         "group")
    return idx, coef


def _check_inputs(arr, net, vm, va, mean):
    n = net.row_ptr.numel() - 1
    m = arr.mean.shape[0]
    for name, t, width in (("vm", vm, n), ("va", va, n), ("mean", mean, m)):
        if t.dim() != 2 or t.shape != (vm.shape[0], width):
            raise ValueError(f"{name} must have shape [B, {width}] with the "
                             f"B of vm, got {tuple(t.shape)}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != arr.status.device or t.device != net.cols.device:
            raise ValueError(f"{name} is on {t.device}, the measurement set "
                             f"on {arr.status.device} and the network on "
                             f"{net.cols.device}")
    if vm.shape[0] < 1 or n < 1 or m < 1:
        raise ValueError(f"empty input: B={vm.shape[0]}, n={n}, m={m}")


def se_fill(arr, net, vm, va, mean, jacobian: bool = True,
            mask_slack: bool = True) -> SeFill:
    """h, residuals and (``jacobian=True``) the masked Jacobian for the
    ``[B, n]`` states ``vm``/``va`` and ``[B, m]`` means of the measurement
    set ``arr`` (``SeArrays``) on the network ``net`` (``AcArrays``).
    ``mask_slack=False`` keeps the slack column (``build_h``'s H)."""
    _check_inputs(arr, net, vm, va, mean)
    if vm.device.type == "cpu":
        return se_fill_ref(arr, net, vm, va, mean, jacobian, mask_slack)
    if vm.device.type != "cuda":
        raise ValueError(f"se_fill runs on cuda or cpu tensors, not "
                         f"{vm.device}")
    return _launch(arr, net, vm, va, mean, jacobian, mask_slack)


se_fill.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("se_fill")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.se_fill_launch.argtypes = (
        [ptr] * 3 + [i32] + [ptr] * 11 + [i32] * 3 + [ptr])
    lib.se_fill_launch.restype = i32
    lib.se_fill_routed_launch.argtypes = (
        [ptr] * 3 + [i32] + [ptr] * 15 + [i32] * 7 + [ptr])
    lib.se_fill_routed_launch.restype = i32
    lib.se_fill_error_string.argtypes = [i32]
    lib.se_fill_error_string.restype = ctypes.c_char_p
    return lib


def _check_tables(arr, net) -> None:
    table = arr.desc
    for name, t, dtype in (("desc.idx", table.idx, torch.int32),
                           ("desc.coef", table.coef, torch.float64),
                           ("status", arr.status, torch.float64),
                           ("net.row_ptr", net.row_ptr, torch.int32),
                           ("net.cols", net.cols, torch.int32),
                           ("net.yg", net.yg, torch.float64),
                           ("net.yb", net.yb, torch.float64),
                           ("net.diag", net.diag, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dtype}")


def _launch(arr, net, vm, va, mean, jacobian: bool,
            mask_slack: bool) -> SeFill:
    _check_tables(arr, net)
    table = arr.desc
    vm, va, mean = (t.contiguous() for t in (vm, va, mean))
    batch, n = vm.shape
    m = mean.shape[1]
    lib = _library()
    out = torch.empty((2, batch, m), dtype=torch.float64, device=vm.device)
    h, r = out.unbind(0)
    jac = (torch.empty((batch, m, 2 * n), dtype=torch.float64,
                       device=vm.device) if jacobian else None)
    with torch.cuda.device(vm.device):
        stream = torch.cuda.current_stream(vm.device).cuda_stream
        err = lib.se_fill_launch(
            table.idx.data_ptr(), table.coef.data_ptr(),
            arr.status.data_ptr(), int(arr.slack) if mask_slack else -1,
            net.row_ptr.data_ptr(), net.cols.data_ptr(), net.yg.data_ptr(),
            net.yb.data_ptr(), net.diag.data_ptr(), vm.data_ptr(),
            va.data_ptr(), mean.data_ptr(), h.data_ptr(), r.data_ptr(),
            None if jac is None else jac.data_ptr(), n, m, batch, stream)
    if err != 0:
        raise RuntimeError("se_fill launch failed: "
                           + lib.se_fill_error_string(err).decode())
    se_fill.launches += 1
    return SeFill(h, r, jac)


def se_fill_routed(arr, net, route: SeRoute, vm, va, scale,
                   block_lo: int = 0, block_hi: Optional[int] = None):
    """h, residuals (``[m]``) and the routed per-block H (``[block_hi -
    block_lo, mr, 2ni + 2lb]``, W½-scaled by ``scale``) at the state
    ``vm``/``va`` (``[n]`` each) of the measurement set ``arr`` on the
    network ``net``."""
    k = route.colmap.shape[0]
    block_hi = k if block_hi is None else block_hi
    if not 0 <= block_lo <= block_hi <= k:
        raise ValueError(f"blocks [{block_lo}, {block_hi}) outside [0, {k})")
    _check_inputs(arr, net, vm[None], va[None], arr.mean[None])
    if scale.shape != arr.mean.shape or scale.dtype != torch.float64:
        raise ValueError("scale must be float64 of the shape of mean")
    if vm.device.type == "cpu":
        return se_fill_routed_ref(arr, net, route, vm, va, scale, block_lo,
                                  block_hi)
    if vm.device.type != "cuda":
        raise ValueError(f"se_fill_routed runs on cuda or cpu tensors, not "
                         f"{vm.device}")
    return _launch_routed(arr, net, route, vm, va, scale, block_lo, block_hi)


se_fill_routed.launches = 0


def _launch_routed(arr, net, route: SeRoute, vm, va, scale, block_lo: int,
                   block_hi: int) -> SeFill:
    _check_tables(arr, net)
    for name in ("row_block", "row_slot", "colmap"):
        t = getattr(route, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"SeRoute.{name} must be contiguous int32")
    vm, va, scale = vm.contiguous(), va.contiguous(), scale.contiguous()
    mean = arr.mean.contiguous()
    n, m = vm.shape[0], mean.shape[0]
    width = 2 * route.ni + 2 * route.lb
    lib = _library()
    out = torch.empty((2, m), dtype=torch.float64, device=vm.device)
    h, r = out.unbind(0)
    jac = torch.empty((block_hi - block_lo, route.mr, width),
                      dtype=torch.float64, device=vm.device)
    with torch.cuda.device(vm.device):
        stream = torch.cuda.current_stream(vm.device).cuda_stream
        err = lib.se_fill_routed_launch(
            arr.desc.idx.data_ptr(), arr.desc.coef.data_ptr(),
            arr.status.data_ptr(), int(arr.slack), net.row_ptr.data_ptr(),
            net.cols.data_ptr(), net.yg.data_ptr(), net.yb.data_ptr(),
            net.diag.data_ptr(), vm.data_ptr(), va.data_ptr(),
            mean.data_ptr(), h.data_ptr(), r.data_ptr(),
            route.row_block.data_ptr(), route.row_slot.data_ptr(),
            route.colmap.data_ptr(), scale.data_ptr(),
            jac.data_ptr() if jac.numel() else None, n, m, route.ni,
            route.lb, route.mr, block_lo, block_hi, stream)
    if err != 0:
        raise RuntimeError("se_fill routed launch failed: "
                           + lib.se_fill_error_string(err).decode())
    se_fill_routed.launches += 1
    return SeFill(h, r, jac)


def se_fill_routed_ref(arr, net, route: SeRoute, vm, va, scale,
                       block_lo: int = 0,
                       block_hi: Optional[int] = None) -> SeFill:
    """Plain PyTorch routed K3: ``h_entries`` times the row status, then
    the JAX package's per-block scatter of ``_gains_block``
    (acse_bbd.py:286-295) — interior entries at their slot, border entries
    at 2ni + their local slot, each masked and times ``scale`` of its row.
    The CPU path, and the check the routed kernel is held to on the
    card."""
    from ..estimation.acse import h_entries

    k = route.colmap.shape[0]
    block_hi = k if block_hi is None else block_hi
    vals, h = h_entries(arr, net, vm, va)
    r = arr.mean - h
    vals = vals * arr.status[route.ent_rows]
    jac = vm.new_zeros((block_hi - block_lo, route.mr,
                        2 * route.ni + 2 * route.lb))
    for sel, blk, row, col, mask, col0 in (
            (route.hi_sel, route.hi_blk, route.hi_row, route.hi_col,
             route.mask_int, 0),
            (route.hb_sel, route.hb_blk, route.hb_row, route.hb_col,
             route.mask_lb, 2 * route.ni)):
        keep = (blk >= block_lo) & (blk < block_hi)
        sel, blk, row, col = sel[keep], blk[keep], row[keep], col[keep]
        v = vals[sel] * mask[blk, col] * scale[route.ent_rows[sel]]
        jac.index_put_((blk - block_lo, row, col0 + col), v, accumulate=True)
    return SeFill(h, r, jac)


def se_fill_ref(arr, net, vm, va, mean, jacobian: bool = True,
                mask_slack: bool = True) -> SeFill:
    """Plain PyTorch K3: ``h_entries``, the ``build_h`` scatter and the
    status and slack-column masks of acse.py, with a leading scenario axis.
    The CPU path, and the check K3 is held to on the card."""
    # acse.py imports this module for se_fill, so its row-group functions
    # are looked up at call time
    from ..estimation.acse import h_entries, h_entry_pattern

    batch, n = vm.shape
    m = mean.shape[1]
    vals, h = h_entries(arr, net, vm, va)
    r = mean - h
    if not jacobian:
        return SeFill(h, r, None)
    ent_rows, ent_cols = h_entry_pattern(arr, net, n)
    jac = torch.zeros((batch, m * 2 * n), dtype=vm.dtype, device=vm.device)
    jac.index_add_(1, ent_rows * (2 * n) + ent_cols, vals)
    jac = jac.view(batch, m, 2 * n)
    jac.mul_(arr.status[:, None])
    if mask_slack:
        col_mask = torch.ones(2 * n, dtype=vm.dtype, device=vm.device)
        col_mask[arr.slack] = 0.0
        jac.mul_(col_mask)
    return SeFill(h, r, jac)
