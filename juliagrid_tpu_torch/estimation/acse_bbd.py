"""Gauss-Newton WLS state estimation on the BBD/Schur substrate, on PyTorch
tensors.

Port of ``juliagrid_tpu/estimation/acse_bbd.py``. The dense SE path
(``acse.py``) fills one (m x 2n) H and forms the gain with one matmul —
fine to a few thousand buses, out of reach at 10k and more. Here the gain
matrix never exists globally:

  1. buses are partitioned on the SQUARED nodal pattern (the gain graph:
     an injection row couples buses two hops apart) with
     ``ops/partition.nd_partition``, so every measurement row's variables
     lie in one interior block and the border;
  2. measurement rows go to the block of their interior variables
     (border-only rows round-robin); each block's columns are its interior
     variables and the border buses it touches (its local border);
  3. each increment, one launch of K3's routed mode
     (``kernels/se_fill.py::se_fill_routed``) writes every block's
     W½-scaled [mr, 2ni + 2lb] H, one batched ``torch.matmul`` gives the
     block gains G_ii, G_ib and S_kk as sub-blocks of HᵀH and the
     right-hand sides as Hᵀ(W½r), the interiors are LU-solved in one
     batched call, and K5 (``kernels/schur_gather.py``) gathers the
     per-block Schur contributions into the border system —
     O(k ni³ + mb³) instead of O((2n)³).

Everything is f64: the JAX package's f32 H, its ``Precision.HIGHEST`` gain
and its streamed/batched gate (``_GAIN_BATCH_ELEMS``, sized for a 16 GB
TPU) are gone. Where the blocks' matrices would not fit the card's free
memory, the same code runs over chunks of blocks.

Correlated rectangular PMU pairs are not supported on this path (use the
dense path); they raise, mirroring the reference's guard on the orthogonal
method (acStateEstimation.jl:47-49).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_device
from ..kernels.schur_gather import SchurRoute, schur_gather
from ..kernels.se_fill import SeRoute, se_fill_routed
from ..ops import linalg
from ..ops.bbd import _vec
from ..ops.partition import nd_partition
from ..powerflow.ac import AcArrays, Polar, compile_ac_arrays
from ..system.model import model
from ..system.types import PowerSystem
from ..utils.errors import MethodError_
from ..utils.profiling import mark
from .acse import (AcStateEstimation, SeArrays, SeMethod, compile_se_arrays,
                   h_entry_pattern)


class SeBbdArrays(NamedTuple):
    """Device snapshot of the BBD estimator: the measurement rows and the
    network K3 reads, K3's routed tables, the row and variable layouts,
    the masks and K5's gather tables."""

    base: SeArrays
    net: AcArrays
    route: SeRoute          # K3 routed mode (and its plain version's tables)
    rows_idx: torch.Tensor  # i64[k, mr] measurement row per slot (pad 0)
    row_mask: torch.Tensor  # f64[k, mr]
    lb_gidx: torch.Tensor   # i64[k, 2lb] local -> global border slot (2mb)
    var_pos: torch.Tensor   # i64[2, n] θ / V of each bus in [k 2ni | 2mb]
    mask_int: torch.Tensor  # f64[k, 2ni]
    mask_bdr: torch.Tensor  # f64[2mb]
    schur: SchurRoute       # K5: the per-block contributions -> border


@dataclass
class _SeBbdLayout:
    k: int
    ni: int
    mb: int
    mr: int
    lb: int


def se_bbd_tables(system: PowerSystem, arr: SeArrays, net: AcArrays,
                  n_blocks: int) -> dict:
    """The host routing tables of the JAX package's ``compile_se_bbd`` for
    the measurement rows ``arr`` on the network ``net`` (device arrays), as
    numpy arrays under its ``SeBbdArrays`` field names. The per-entry loops
    of the JAX package are vectorized (about 1M entries at 25k buses)."""
    n = system.bus.number
    model(system, "ac")
    nodal = system.model.ac.nodal.tocsr()
    pat = sp.csr_matrix((np.ones(nodal.nnz), nodal.indices, nodal.indptr),
                        shape=nodal.shape)
    gain_pat = (pat @ pat).tocsr()
    block_of, border = nd_partition(gain_pat, n_blocks)
    k = n_blocks
    sizes = np.bincount(block_of[block_of >= 0], minlength=k)
    ni = max(int(sizes.max()), 1)
    mb = max(len(border), 1)

    bus_block = block_of.astype(np.int64)
    bus_slot = np.zeros(n, dtype=np.int64)
    order = np.argsort(block_of, kind="stable")
    interior = order[block_of[order] >= 0]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    bus_slot[interior] = (np.arange(len(interior))
                          - starts[block_of[interior]])
    bus_slot[border] = np.arange(len(border))

    ent_rows, ent_cols = (t.cpu().numpy().astype(np.int64)
                          for t in h_entry_pattern(arr, net, n))
    m = int(arr.mean.shape[0])

    # row -> block: the block of any interior variable it touches (the
    # squared-pattern partition makes it unique); border-only rows
    # round-robin for load balance
    ent_bus = ent_cols % n
    b_e = bus_block[ent_bus]
    touch = b_e >= 0
    lo = np.full(m, k, dtype=np.int64)
    hi = np.full(m, -1, dtype=np.int64)
    np.minimum.at(lo, ent_rows[touch], b_e[touch])
    np.maximum.at(hi, ent_rows[touch], b_e[touch])
    two = np.flatnonzero((hi >= 0) & (lo != hi))
    if len(two):
        r = int(two[0])
        raise RuntimeError(
            "SE BBD routing: row touches two interiors "
            f"(row {r}: blocks {lo[r]} and {hi[r]})")
    row_block = hi.copy()
    none = np.flatnonzero(row_block < 0)
    row_block[none] = np.arange(len(none)) % k

    counts = np.bincount(row_block, minlength=k)
    mr = max(int(counts.max()), 1)
    by_block = np.argsort(row_block, kind="stable")
    row_slot = np.zeros(m, dtype=np.int64)
    row_slot[by_block] = (np.arange(m) - np.concatenate(
        [[0], np.cumsum(counts)])[row_block[by_block]])
    rows_idx = np.zeros((k, mr), dtype=np.int64)
    row_mask = np.zeros((k, mr))
    rows_idx[row_block, row_slot] = np.arange(m)
    row_mask[row_block, row_slot] = 1.0

    # entry routing; border columns compressed to each block's local border
    is_mag = ent_cols >= n
    blk_e = row_block[ent_rows]
    lrow_e = row_slot[ent_rows]
    sel = np.arange(len(ent_rows))
    hi_e = bus_block[ent_bus] >= 0
    hb_e = ~hi_e
    lcol_int = bus_slot[ent_bus] + np.where(is_mag, ni, 0)

    # local border lists per block: the global border slots touched, in
    # ascending order
    keys = np.unique(blk_e[hb_e] * mb + bus_slot[ent_bus[hb_e]])
    u_blk, u_slot = keys // mb, keys % mb
    counts = np.bincount(u_blk, minlength=k)
    lb = max(int(counts.max()) if len(keys) else 0, 1)
    rank = np.arange(len(keys)) - np.concatenate(
        [[0], np.cumsum(counts)])[u_blk]
    lb_gidx = np.full((k, 2 * lb), 2 * mb, dtype=np.int64)  # pad sentinel
    lb_gidx[u_blk, rank] = u_slot
    lb_gidx[u_blk, lb + rank] = mb + u_slot
    local_of = np.zeros((k, mb), dtype=np.int64)
    local_of[u_blk, u_slot] = rank
    lcol_bdr = (local_of[blk_e[hb_e], bus_slot[ent_bus[hb_e]]]
                + np.where(is_mag[hb_e], lb, 0))

    # masks: real slots active; slack angle pinned
    slack = int(arr.slack)
    mask_int = np.zeros((k, 2 * ni))
    real = np.arange(ni)[None, :] < sizes[:, None]
    mask_int[:, :ni] = real
    mask_int[:, ni:] = real
    mask_bdr = np.zeros(2 * mb)
    mask_bdr[:len(border)] = 1.0
    mask_bdr[mb:mb + len(border)] = 1.0
    if bus_block[slack] >= 0:
        mask_int[bus_block[slack], bus_slot[slack]] = 0.0
    else:
        mask_bdr[bus_slot[slack]] = 0.0

    i32 = lambda x: np.asarray(x, dtype=np.int32)  # noqa: E731
    return dict(
        ent_rows=i32(ent_rows),
        hi_sel=i32(sel[hi_e]), hi_blk=i32(blk_e[hi_e]),
        hi_row=i32(lrow_e[hi_e]), hi_col=i32(lcol_int[hi_e]),
        hb_sel=i32(sel[hb_e]), hb_blk=i32(blk_e[hb_e]),
        hb_row=i32(lrow_e[hb_e]), hb_col=i32(lcol_bdr),
        rows_idx=i32(rows_idx), row_mask=row_mask, lb_gidx=i32(lb_gidx),
        bus_block=i32(bus_block), bus_slot=i32(bus_slot),
        mask_int=mask_int, mask_bdr=mask_bdr)


def compile_se_bbd(system: PowerSystem, monitoring, n_blocks: int,
                   device=None):
    """``(SeBbdArrays, _SeBbdLayout, types, row_device)`` on ``device``
    (default ``config.device``)."""
    # convert.py builds SeBbdArrays from numpy and imports this module
    from ..convert import se_bbd_arrays_from_numpy
    dev = resolve_device(device)
    arr, types, row_device = compile_se_arrays(system, monitoring,
                                               device=dev)
    if arr.pair_r1.shape[0]:
        raise MethodError_(
            "A non-diagonal precision matrix prevents the use of the "
            "BBD method; use the dense Normal path.")
    net = compile_ac_arrays(system, dev)
    sb, layout = se_bbd_arrays_from_numpy(
        base=arr, net=net, **se_bbd_tables(system, arr, net, n_blocks),
        device=dev)
    return sb, layout, types, row_device


def _block_chunk(layout: _SeBbdLayout, device: torch.device) -> int:
    """How many blocks one pass of the gain stage takes: all of them,
    unless their H, gain and factors (about 8 (mr c + 3 c²) bytes a block,
    c = 2ni + 2lb) would pass half of the card's free memory, counting
    what PyTorch's allocator holds cached but unused as free."""
    if device.type != "cuda":
        return layout.k
    width = 2 * layout.ni + 2 * layout.lb
    per_block = 8 * (layout.mr * width + 3 * width * width)
    free = (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    return int(min(layout.k, max(1, free // 2 // per_block)))


def _gn_increment_bbd(sb: SeBbdArrays, layout: _SeBbdLayout, vm, va,
                      chunk: int = 0):
    """One Gauss-Newton increment at ``(vm, va)``: ``(dx [2n], max|dx|)``.
    ``chunk`` blocks go through the gain stage at a time (0: as many as
    the free memory holds)."""
    k, ni, mb = layout.k, layout.ni, layout.mb
    arr = sb.base
    chunk = chunk or _block_chunk(layout, vm.device)
    sqw = arr.w.sqrt()
    n2i = 2 * ni
    y = vm.new_empty((k, n2i))
    z = vm.new_empty((k, n2i, 2 * layout.lb))
    s_contrib = vm.new_empty((k, 2 * layout.lb, 2 * layout.lb))
    rhs_contrib = vm.new_empty((k, 2 * layout.lb))
    for lo in range(0, k, chunk):
        hi = min(k, lo + chunk)
        mark("K3 routed")
        res = se_fill_routed(arr, sb.net, sb.route, vm, va, sqw, lo, hi)
        mark("gain")
        hs = res.jac                                   # W½ H, [c, mr, width]
        wr = (sqw * res.r)[sb.rows_idx[lo:hi]] * sb.row_mask[lo:hi]
        gain = hs.mT @ hs
        rhs = _vec(hs.mT, wr)
        del hs, res
        g_ii = gain[:, :n2i, :n2i]
        g_ii.diagonal(dim1=-2, dim2=-1).add_(1.0 - sb.mask_int[lo:hi])
        g_ib = gain[:, :n2i, n2i:]
        y[lo:hi], z[lo:hi] = linalg.batched_lu_solve2(g_ii, rhs[:, :n2i],
                                                      g_ib)
        mark("Schur products")
        s_contrib[lo:hi] = gain[:, n2i:, n2i:] - g_ib.mT @ z[lo:hi]
        rhs_contrib[lo:hi] = rhs[:, n2i:] - _vec(g_ib.mT, y[lo:hi])
        del gain
    mark("K5")
    schur, rhs_s = schur_gather(sb.schur, s_contrib, rhs_contrib)
    schur.diagonal().add_(1.0 - sb.mask_bdr)
    mark("border LU")
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU), rhs_s)
    mark("back-sub")
    x_b_loc = torch.cat([x_b, x_b.new_zeros(1)])[sb.lb_gidx]
    x = torch.cat([(y - _vec(z, x_b_loc)).reshape(-1), x_b])
    dx = torch.cat([x[sb.var_pos[0]], x[sb.var_pos[1]]])
    return dx, dx.abs().amax()


def _se_bbd_solve(sb: SeBbdArrays, layout: _SeBbdLayout, vm, va, tol: float,
                  max_iter: int, chunk: int = 0):
    """The BBD Gauss-Newton loop, as the JAX package's (acse_bbd.py:
    353-372): the first increment before the loop, then apply, recompute,
    count; one scalar readback per increment. The device stages are marked
    for ``utils.profiling.device_stages``."""
    n = vm.shape[0]
    dx, maxinc = _gn_increment_bbd(sb, layout, vm, va, chunk)
    mark("readback")
    inc = float(maxinc)
    it = 0
    while inc >= tol and it < max_iter:
        va = va + dx[:n]
        vm = vm + dx[n:]
        dx, maxinc = _gn_increment_bbd(sb, layout, vm, va, chunk)
        mark("readback")
        inc = float(maxinc)
        it += 1
    mark(None)
    return vm, va, it, inc, inc < tol


def gauss_newton_bbd(monitoring, n_blocks: int = 8,
                     device=None) -> AcStateEstimation:
    """Gauss-Newton WLS with the BBD/Schur gain substrate (scale path), on
    ``device`` (default ``config.device``)."""
    device = resolve_device(device)
    system = monitoring.system
    system.check_slack()
    model(system, "ac")
    n = system.bus.number
    sb, layout, types, row_device = compile_se_bbd(system, monitoring,
                                                   n_blocks, device)
    rev = system.model.revision
    method = SeMethod("gauss_newton_bbd")
    method.type = types
    method.row_device = row_device
    analysis = AcStateEstimation(
        system=system,
        monitoring=monitoring,
        voltage=Polar(system.bus.voltage.magnitude.array[:n].copy(),
                      system.bus.voltage.angle.array[:n].copy()),
        method=method,
        arrays=sb.base,
        net=sb.net,
        device=device,
        signature={"ac_model": rev.ac_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values,
                   "slack": rev.slack},
    )
    analysis._bbd = sb
    analysis._bbd_layout = layout
    analysis._bbd_n_blocks = n_blocks
    return analysis


def se_bbd_refresh(analysis: AcStateEstimation):
    """Signature-protocol staleness refresh for the BBD SE snapshot."""
    rev = analysis.system.model.revision
    mrev = analysis.monitoring.revision
    sig = analysis.signature
    if (sig.get("ac_model") != rev.ac_model
            or sig.get("measurement") != mrev.measurement
            or sig.get("meas_values") != mrev.values
            or sig.get("slack") != rev.slack):
        sb, layout, types, row_device = compile_se_bbd(
            analysis.system, analysis.monitoring, analysis._bbd_n_blocks,
            analysis.device)
        analysis._bbd = sb
        analysis._bbd_layout = layout
        analysis.arrays = sb.base
        analysis.net = sb.net
        analysis.method.type = types
        analysis.method.row_device = row_device
        sig.update(ac_model=rev.ac_model, measurement=mrev.measurement,
                   meas_values=mrev.values, slack=rev.slack)


def se_bbd_solve(analysis: AcStateEstimation, iteration: int = 40,
                 tolerance: float = 1e-8):
    """Driver for the BBD Gauss-Newton analysis."""
    se_bbd_refresh(analysis)
    vm, va = analysis._state()
    vm, va, it, maxinc, converged = _se_bbd_solve(
        analysis._bbd, analysis._bbd_layout, vm, va, tolerance, iteration)
    analysis.voltage.magnitude = vm.cpu().numpy()
    analysis.voltage.angle = va.cpu().numpy()
    analysis.method.iteration = it
    analysis.method.converged = converged
    analysis.method.max_increment = maxinc
    return analysis
