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
``SeArrays``, with the rows' class order (``row_classes``: closed-form rows,
then injection rows) that the launch without the Jacobian maps by. A call
is one launch: H is zeroed inside the kernel, and the table pointers are
gathered into one ``_Tables`` struct at the first launch on a measurement
set (or partition), not per call. ``se_fill`` dispatches on the device of
its tensors: a CUDA
tensor goes to the kernel (and the call raises if the kernel does not build
or launch), a CPU tensor to ``se_fill_ref``, the plain PyTorch
transcription of the jnp code. ``se_fill.launches`` counts kernel launches.

``se_fill_entries`` is K3's entry mode, the main path of the WLS
estimators: no dense H, but the entry values ``[B, E]`` in
``h_entry_pattern``'s order, masked as ``gn_increment`` masks them
(``vals * status[ent_rows] * col_mask[ent_cols]``, acse.py:642), with h and
r; every entry has one writer, at a position the host builds once
(``entry_positions``). K8 (``kernels/gain_fill.py``) forms the normal
equations from them. It dispatches the same way, to
``se_fill_entries_ref`` on the CPU, and counts its own launches in
``se_fill_entries.launches``.

``se_fill_routed`` is K3's routed mode for the BBD estimator
(``estimation/acse_bbd.py``): one state, and instead of the dense H one
``[mr, 2ni + 2lb]`` matrix per block of the partition (its rows, its
interior columns, its local border columns), scaled by W½, written through
the row and column maps of an ``SeRoute`` (its ``slot_row``, the row on
each slot of each block, is what the kernel walks). It dispatches the same
way, to
``se_fill_routed_ref`` on the CPU, and counts its own launches in
``se_fill_routed.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.equations import BRANCH_GROUPS
from . import _build

#: descriptor type codes: the measurement type codes of ``compile_se_arrays``
#: with the PMU magnitude row (12) folded into the voltmeter row (1)
VM, VA, RE_V, IM_V, P_INJ, Q_INJ = 1, 13, 16, 17, 6, 9


class SeFillTable(NamedTuple):
    """K3's per-row descriptor table (structure of arrays, one column per
    measurement row)."""

    idx: torch.Tensor    # i32[3, m]: type code, bus or from-bus, to-bus (-1)
    coef: torch.Tensor   # f64[5, m]: PiModel a, b, c, d and shift angle phi
    order: torch.Tensor  # i32[m]: closed-form rows, then injection rows
    closed: int          # closed-form rows (the head of order)
    epos: torch.Tensor   # i32[4, m]: entry_positions
    entries: int         # E, the pattern's entries


class SeRoute(NamedTuple):
    """Where K3's routed mode writes, and the entry routing of the JAX
    package's per-block H (``SeBbdArrays.hi_*``/``hb_*``) that its plain
    version scatters through."""

    row_block: torch.Tensor  # i32[m] block of each measurement row
    row_slot: torch.Tensor   # i32[m] row slot inside its block
    slot_row: torch.Tensor   # i32[k mr] the inverse: row of a slot, -1 pad
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


class SeEntries(NamedTuple):
    """K3's entry-mode outputs, with the leading scenario axis B."""

    h: torch.Tensor     # f64[B, m] model values times row status
    r: torch.Tensor     # f64[B, m] residuals mean - h
    vals: torch.Tensor  # f64[B, E] masked H entries, h_entry_pattern order


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


def entry_positions(host) -> tuple[np.ndarray, int]:
    """``(epos [4, m], E)``: where K3's entry mode writes each row's values
    in ``h_entry_pattern``'s order (its blocks: voltmeter, angle and
    rectangular PMU rows, each branch group's four columns, then P and Q
    injections' Y-entry angle and magnitude blocks and their diagonal
    pairs), from the host mirror of an ``SeArrays``. A closed-form row's
    value of slot s lies at ``epos[s, row]``; an injection row's values at
    Y entry k at ``epos[0, row] + k`` (angle) and ``epos[1, row] + k``
    (magnitude), its diagonal pair at ``epos[2, row]``, ``epos[3, row]``.
    Raises unless an injection row's Y entries are consecutive, as the
    kernel walks them."""
    m = len(host.mean)
    epos = np.full((4, m), -1, dtype=np.int64)
    pos = 0

    def block(rows, slot):
        nonlocal pos
        rows = np.asarray(rows, dtype=np.int64)
        epos[slot, rows] = pos + np.arange(len(rows))
        pos += len(rows)

    block(host.vm_rows, 0)
    block(host.va_rows, 0)
    for rows in (host.rev_rows, host.imv_rows):
        block(rows, 0)
        block(rows, 1)
    for grp in host.branch:
        if len(grp.rows):
            for slot in range(4):
                block(grp.rows, slot)
    for rows, meas, ent_k in ((host.p_rows, host.p_ent_meas, host.p_ent_k),
                              (host.q_rows, host.q_ent_meas, host.q_ent_k)):
        rows = np.asarray(rows, dtype=np.int64)
        if not len(rows):
            continue
        meas = np.asarray(meas, dtype=np.int64)
        ent_k = np.asarray(ent_k, dtype=np.int64)
        if not len(meas):
            raise ValueError("an injection row has no Y entries")
        # the runs of equal rows in meas, in order: one run a row
        first = np.flatnonzero(np.r_[True, meas[1:] != meas[:-1]])
        lens = np.diff(np.r_[first, len(meas)])
        if (len(first) != len(rows) or not np.array_equal(meas[first], rows)
                or not np.array_equal(
                    ent_k - np.repeat(ent_k[first] - first, lens),
                    np.arange(len(ent_k)))):
            raise ValueError("an injection row's Y entries are not one "
                             "consecutive run")
        base = first - ent_k[first]
        epos[0, rows] = pos + base
        epos[1, rows] = pos + len(meas) + base
        pos += 2 * len(meas)
        block(rows, 2)
        block(rows, 3)
    if pos >= 2 ** 31:
        raise ValueError("K3's entry mode indexes with int32")
    return epos.astype(np.int32), pos


def row_classes(idx) -> tuple[np.ndarray, int]:
    """``(order, closed)``: the rows of the descriptor table ``idx`` with
    the closed-form rows first and the injection rows (types 6, 9) after,
    each class in ascending row order, and the count of closed-form rows.
    Without the Jacobian K3 gives a closed-form row a thread and an
    injection row a warp."""
    inj = np.isin(np.asarray(idx)[0], (P_INJ, Q_INJ))
    order = np.concatenate([np.flatnonzero(~inj), np.flatnonzero(inj)])
    return order.astype(np.int32), int(np.count_nonzero(~inj))


def slot_rows(row_block, row_slot, k: int, mr: int) -> np.ndarray:
    """The ``[k mr]`` inverse of the row -> (block, slot) map: the
    measurement row on each slot of each block, -1 on a pad slot. Raises
    unless every row has a slot of its own."""
    row_block = np.asarray(row_block, dtype=np.int64)
    row_slot = np.asarray(row_slot, dtype=np.int64)
    flat = row_block * mr + row_slot
    if (np.any(row_block < 0) or np.any(row_block >= k)
            or np.any(row_slot < 0) or np.any(row_slot >= mr)
            or len(np.unique(flat)) != len(flat)):
        raise ValueError("every measurement row needs a slot of its own")
    out = np.full(k * mr, -1, dtype=np.int32)
    out[flat] = np.arange(len(flat))
    return out


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
        [ptr] * 2 + [i32] + [ptr] * 6 + [i32, ptr])
    lib.se_fill_launch.restype = i32
    lib.se_fill_routed_launch.argtypes = (
        [ptr] * 2 + [i32] + [ptr] * 7 + [i32] * 2 + [ptr])
    lib.se_fill_routed_launch.restype = i32
    lib.se_fill_entries_launch.argtypes = (
        [ptr] * 2 + [i32] + [ptr] * 6 + [i32, ptr])
    lib.se_fill_entries_launch.restype = i32
    lib.se_fill_error_string.argtypes = [i32]
    lib.se_fill_error_string.restype = ctypes.c_char_p
    return lib


class _Tables(ctypes.Structure):
    """``SeTables`` of csrc/se_fill.cu."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "idx", "coef", "order", "row_ptr", "cols", "yg", "yb", "diag",
        "slot_row", "colmap", "epos")]
        + [(name, ctypes.c_int) for name in (
            "n", "m", "closed", "ni", "lb", "mr", "k", "entries")])


#: the ``_Tables`` of each measurement set (keyed by its ``desc.idx``; the
#: entry mode's by its ``desc.epos``) or partition (keyed by its
#: ``SeRoute.slot_row``), with the tensors they point into; built at the
#: first launch, and again if the network changes
_DENSE = WeakIdKeyDictionary()
_ENTRY = WeakIdKeyDictionary()
_ROUTED = WeakIdKeyDictionary()


def _tables(cache, key_name: str, key, tensors: dict, on_build=None,
            **ints) -> int:
    """The address of the ``_Tables`` of ``key`` (its field ``key_name``)
    and ``tensors``, checked (and ``on_build()`` called) and built once for
    as long as the same tensors come with ``key``. The entry holds
    ``tensors`` but not ``key``, so that it goes when ``key`` does."""
    held = tuple(tensors.values())
    entry = cache.get(key)
    if entry is None or any(a is not b for a, b in zip(entry[1], held)):
        for name, t in ((key_name, key), *tensors.items()):
            want = torch.float64 if t.is_floating_point() else torch.int32
            if t.dtype != want or not t.is_contiguous():
                raise TypeError(f"{name} must be contiguous {want}")
        if on_build is not None:
            on_build()
        ptrs = {name: t.data_ptr() for name, t in tensors.items()}
        entry = (_Tables(**{key_name: key.data_ptr()}, **ptrs, **ints), held)
        cache[key] = entry
    return ctypes.addressof(entry[0])


def _net_tensors(net) -> dict:
    return dict(row_ptr=net.row_ptr, cols=net.cols, yg=net.yg, yb=net.yb,
                diag=net.diag)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _library().se_fill_error_string(err).decode())


def _launch(arr, net, vm, va, mean, jacobian: bool,
            mask_slack: bool) -> SeFill:
    table = arr.desc
    batch, n = vm.shape
    m = mean.shape[1]
    tables = _tables(_DENSE, "idx", table.idx,
                     dict(coef=table.coef, order=table.order,
                          **_net_tensors(net)),
                     n=n, m=m, closed=table.closed)
    if arr.status.dtype != torch.float64 or not arr.status.is_contiguous():
        raise TypeError("status must be contiguous float64")
    vm, va, mean = vm.contiguous(), va.contiguous(), mean.contiguous()
    out = torch.empty((2, batch, m), dtype=torch.float64, device=vm.device)
    jac = (torch.empty((batch, m, 2 * n), dtype=torch.float64,
                       device=vm.device) if jacobian else None)
    ctx, stream = _build.launch_context(vm.device)
    with ctx:
        err = _library().se_fill_launch(
            tables, arr.status.data_ptr(),
            int(arr.slack) if mask_slack else -1, vm.data_ptr(),
            va.data_ptr(), mean.data_ptr(), out.data_ptr(),
            out.data_ptr() + 8 * batch * m,
            None if jac is None else jac.data_ptr(), batch, stream)
    _check(err, "se_fill")
    se_fill.launches += 1
    return SeFill(out[0], out[1], jac)


def se_fill_entries(arr, net, vm, va, mean) -> SeEntries:
    """h, residuals and the masked H entries (``[B, E]``, the order of
    ``h_entry_pattern``) for the ``[B, n]`` states ``vm``/``va`` and ``[B,
    m]`` means of the measurement set ``arr`` on the network ``net``."""
    _check_inputs(arr, net, vm, va, mean)
    if arr.desc is None or arr.desc.epos is None:
        raise ValueError("the measurement set has no entry positions "
                         "(SeFillTable.epos)")
    if vm.device.type == "cpu":
        return se_fill_entries_ref(arr, net, vm, va, mean)
    if vm.device.type != "cuda":
        raise ValueError(f"se_fill_entries runs on cuda or cpu tensors, not "
                         f"{vm.device}")
    return _launch_entries(arr, net, vm, va, mean)


se_fill_entries.launches = 0


def _check_entry_route(arr, net) -> None:
    """An injection row's Y entries (``p_ent_k``/``q_ent_k``, the run
    ``entry_positions`` placed) must be its bus's CSR segment of the
    network, the run K3 walks."""
    row_ptr = net.row_ptr.cpu().numpy().astype(np.int64)
    for bus, ent_k in ((arr.p_bus, arr.p_ent_k), (arr.q_bus, arr.q_ent_k)):
        bus = bus.cpu().numpy()
        lens = row_ptr[bus + 1] - row_ptr[bus]
        first = np.cumsum(lens) - lens
        want = np.repeat(row_ptr[bus] - first, lens) + np.arange(lens.sum())
        if not np.array_equal(ent_k.cpu().numpy(), want):
            raise ValueError("an injection row's Y entries are not its "
                             "bus's CSR segment of the network")


def _launch_entries(arr, net, vm, va, mean) -> SeEntries:
    table = arr.desc
    batch, n = vm.shape
    m = mean.shape[1]
    tables = _tables(_ENTRY, "epos", table.epos,
                     dict(idx=table.idx, coef=table.coef, order=table.order,
                          **_net_tensors(net)),
                     on_build=lambda: _check_entry_route(arr, net),
                     n=n, m=m, closed=table.closed, entries=table.entries)
    if arr.status.dtype != torch.float64 or not arr.status.is_contiguous():
        raise TypeError("status must be contiguous float64")
    vm, va, mean = vm.contiguous(), va.contiguous(), mean.contiguous()
    out = torch.empty((2, batch, m), dtype=torch.float64, device=vm.device)
    vals = torch.empty((batch, table.entries), dtype=torch.float64,
                       device=vm.device)
    ctx, stream = _build.launch_context(vm.device)
    with ctx:
        err = _library().se_fill_entries_launch(
            tables, arr.status.data_ptr(), int(arr.slack), vm.data_ptr(),
            va.data_ptr(), mean.data_ptr(), out.data_ptr(),
            out.data_ptr() + 8 * batch * m, vals.data_ptr(), batch, stream)
    _check(err, "se_fill entries")
    se_fill_entries.launches += 1
    return SeEntries(out[0], out[1], vals)


def se_fill_entries_ref(arr, net, vm, va, mean) -> SeEntries:
    """Plain PyTorch entry mode: ``h_entries`` and the entry masks of
    ``gn_increment`` (acse.py:639-642), with a leading scenario axis. The
    CPU path, and the check the entry mode is held to on the card."""
    from ..estimation.acse import h_entries, h_entry_pattern

    n = vm.shape[1]
    vals, h = h_entries(arr, net, vm, va)
    ent_rows, ent_cols = h_entry_pattern(arr, net, n)
    col_mask = torch.ones(2 * n, dtype=vm.dtype, device=vm.device)
    col_mask[arr.slack] = 0.0
    return SeEntries(h, mean - h,
                     vals * arr.status[ent_rows] * col_mask[ent_cols])


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
    table = arr.desc
    n, m = vm.shape[0], arr.mean.shape[0]
    k = route.colmap.shape[0]
    if route.slot_row.numel() != k * route.mr:
        raise ValueError("SeRoute.slot_row must have k mr entries")
    tables = _tables(_ROUTED, "slot_row", route.slot_row,
                     dict(idx=table.idx, coef=table.coef, order=table.order,
                          **_net_tensors(net), colmap=route.colmap),
                     n=n, m=m, closed=table.closed, ni=route.ni, lb=route.lb,
                     mr=route.mr, k=k)
    for name, t in (("status", arr.status), ("mean", arr.mean)):
        if t.dtype != torch.float64 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float64")
    vm, va, scale = vm.contiguous(), va.contiguous(), scale.contiguous()
    width = 2 * route.ni + 2 * route.lb
    out = torch.empty((2, m), dtype=torch.float64, device=vm.device)
    jac = torch.empty((block_hi - block_lo, route.mr, width),
                      dtype=torch.float64, device=vm.device)
    ctx, stream = _build.launch_context(vm.device)
    with ctx:
        err = _library().se_fill_routed_launch(
            tables, arr.status.data_ptr(), int(arr.slack), vm.data_ptr(),
            va.data_ptr(), arr.mean.data_ptr(), out.data_ptr(),
            out.data_ptr() + 8 * m, scale.data_ptr(),
            jac.data_ptr() if jac.numel() else None, block_lo, block_hi,
            stream)
    _check(err, "se_fill routed")
    se_fill_routed.launches += 1
    return SeFill(out[0], out[1], jac)


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
