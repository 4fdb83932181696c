"""Newton-Raphson power flow on the BBD/Schur substrate, on PyTorch tensors.

Port of ``juliagrid_tpu/powerflow/newton_bbd.py``. The plain NR path
(``ac.py``) builds one dense Jacobian over the unknowns (npv + 2·npq, at
most 2n) — fine to a few thousand buses, out of reach at 25k and more
(49,928² f64 is 19.9 GB). Here the bus
graph is partitioned on the host (``ops/partition.nd_partition``: border
buses separate the blocks, so no Y entry joins two interiors) and every
Jacobian entry is routed at compile time to its destination: a per-block
interior matrix, an interior-border coupling strip in the block's local
border layout, or the border block. Each iteration:

  1. one launch of K1's routed mode (``kernels/nr_fill.py::nr_fill_routed``)
     writes the mismatch and every H/N/J/L value straight into the
     (k, 2ni, 2ni) interiors, the (k, 2ni, 2mbl) / (k, 2mbl, 2ni) couplings
     and the (2mb, 2mb) border of one flat buffer, with masked variables
     already identity;
  2. one batched f64 LU of the interiors and two solves
     (``linalg.batched_lu_solve2``), the per-block Schur contributions as
     one batched product, and K5 (``kernels/schur_gather.py``) gathers them
     into the border system, which is LU-solved;
  3. the back-substitution is one batched product, and one gather takes
     the increments back to bus order.

That is O(k (2ni)³ + (2mb)³) instead of O((2n)³). The loop is a host loop
with one scalar-pair readback per iteration and the reference's
check-then-step semantics (acPowerFlow.jl:1389-1433).

Variable layout: block b holds [θ then V] of its interior buses (padded to
the largest block); the border holds [θ then V] of the border buses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import scipy.sparse as scipy_sp
import torch

from ..config import resolve_device
from ..kernels.nr_fill import NrRoute, nr_fill_routed
from ..kernels.schur_gather import SchurRoute, schur_gather
from ..ops import linalg
from ..ops.bbd import _vec, local_border
from ..ops.partition import nd_partition
from ..system.model import model
from ..system.types import PowerSystem
from ..utils.profiling import mark
from .ac import (AcArrays, AcPowerFlow, MethodState, Polar, ac_entry_host,
                 initialize_ac_power_flow)


class NrBbdArrays(NamedTuple):
    """Device snapshot of the BBD Newton-Raphson: the network K1 reads,
    K1's routed offsets, each bus's variables in the block layout, the
    local border maps and K5's gather tables."""

    net: AcArrays
    route: NrRoute          # K1 routed mode: a_ii | a_ib | a_bi | a_bb
    var_pos: torch.Tensor   # i64[2, n] θ / V of each bus in [k 2ni | 2mb]
    bsel: torch.Tensor      # i64[k, 2mbl] local border slot -> border slot
    bmask: torch.Tensor     # f64[k, 2mbl] 1 for real local slots
    schur: SchurRoute       # K5: the per-block contributions -> border


@dataclass
class _BbdLayout:
    k: int
    ni: int
    mb: int
    mbl: int = 0


def nr_bbd_tables(system: PowerSystem, n_blocks: int) -> dict:
    """The host routing tables of the JAX package's ``compile_nr_bbd``, as
    numpy arrays under its ``NrBbdArrays`` field names (the network's
    fields included); the per-bus loops of the JAX package are
    vectorized."""
    rows, cols, vals_host, diag = ac_entry_host(system)
    n = system.bus.number
    bus = system.bus
    # Partition on the STORED pattern (including the structural zeros that
    # ac_model keeps for out-of-service branches) so every routed entry is
    # same-block or border.
    nodal = system.model.ac.nodal.tocsr()
    pattern = scipy_sp.csr_matrix(
        (np.ones(nodal.nnz), nodal.indices, nodal.indptr), shape=nodal.shape)
    block_of, border = nd_partition(pattern, n_blocks)
    k = n_blocks
    sizes = np.bincount(block_of[block_of >= 0], minlength=k)
    ni = int(sizes.max())
    mb = len(border)

    # slots: ascending bus order inside each block and inside the border
    bus_block = block_of.copy()
    bus_slot = np.zeros(n, dtype=np.int64)
    order = np.argsort(block_of, kind="stable")
    interior = order[block_of[order] >= 0]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    bus_slot[interior] = (np.arange(len(interior))
                          - starts[block_of[interior]])
    bus_slot[border] = np.arange(mb)

    nnz = len(rows)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    yg_host = np.asarray(vals_host.real)
    yb_host = np.asarray(vals_host.imag)
    bb_i = bus_block[rows]
    bb_j = bus_block[cols]
    int_i = bb_i >= 0
    int_j = bb_j >= 0
    cross = int_i & int_j & (bb_i != bb_j)
    # only structurally-zero entries (off branches kept in the pattern)
    # may cross interiors; their H/N/J/L values are identically 0, so
    # dropping them is exact
    bad = cross & ~((rows != cols) & (yg_host == 0.0) & (yb_host == 0.0))
    if bad.any():
        raise RuntimeError(
            "BBD routing: nonzero entry couples two interiors")
    fam = np.where(cross, -1,
                   np.where(int_i & int_j, 0,
                            np.where(int_i, 1, np.where(int_j, 2, 3))))
    e_idx = np.arange(nnz, dtype=np.int64)
    sels, blks, lrows, lcols = [], [], [], []
    for quad, (mi_, mj_) in enumerate(
            ((False, False), (False, True), (True, False), (True, True))):
        # quad order: H (P,θ), N (P,V), J (Q,θ), L (Q,V)
        lrows.append(np.where(int_i, bus_slot[rows] + (ni if mi_ else 0),
                              bus_slot[rows] + (mb if mi_ else 0)))
        lcols.append(np.where(int_j, bus_slot[cols] + (ni if mj_ else 0),
                              bus_slot[cols] + (mb if mj_ else 0)))
        sels.append(quad * nnz + e_idx)
        blks.append(np.where(int_i, bb_i, np.where(int_j, bb_j, 0)))
    sel_all = np.concatenate(sels)
    blk_all = np.concatenate(blks)
    row_all = np.concatenate(lrows)
    col_all = np.concatenate(lcols)
    fam_all = np.tile(fam, 4)

    def pack(f):
        m = fam_all == f
        return (sel_all[m].astype(np.int32), blk_all[m].astype(np.int32),
                row_all[m].astype(np.int32), col_all[m].astype(np.int32))

    ii, ib, bi, bb = pack(0), pack(1), pack(2), pack(3)

    # ---- locality compression of the border couplings ----------------
    # per block: the border BUSES it touches (its ib columns and bi rows),
    # numbered in ascending border order
    mb_s = max(mb, 1)
    keys = np.unique(np.concatenate([
        ib[1].astype(np.int64) * mb_s + ib[3].astype(np.int64) % mb_s,
        bi[1].astype(np.int64) * mb_s + bi[2].astype(np.int64) % mb_s]))
    u_blk, u_q = keys // mb_s, keys % mb_s
    counts = np.bincount(u_blk, minlength=k)
    mbl = max(int(counts.max()) if len(keys) else 1, 1)
    rank = np.arange(len(keys)) - np.concatenate(
        [[0], np.cumsum(counts)])[u_blk]
    loc_of = np.zeros((k, mb_s), dtype=np.int64)
    loc_of[u_blk, u_q] = rank
    bsel = np.full((k, 2 * mbl), 2 * mb, dtype=np.int32)
    bmask = np.zeros((k, 2 * mbl))
    bsel[u_blk, rank] = u_q
    bsel[u_blk, mbl + rank] = mb + u_q
    bmask[u_blk, rank] = 1.0
    bmask[u_blk, mbl + rank] = 1.0

    def to_local(blks, gvars):
        g64 = gvars.astype(np.int64)
        return (loc_of[blks.astype(np.int64), g64 % mb_s]
                + np.where(g64 >= mb, mbl, 0)).astype(np.int32)

    ib = (ib[0], ib[1], ib[2], to_local(ib[1], ib[3]))
    bi = (bi[0], bi[1], to_local(bi[1], bi[2]), bi[3])

    # masks: active angle vars (bus != slack), active magnitude (PQ)
    types = bus.layout.type.array[:n]
    slack = bus.layout.slack
    m_ang = (np.arange(n) != slack).astype(np.float64)
    m_mag = (types == 1).astype(np.float64)
    mask_int = np.zeros((k, 2 * ni))
    mask_int[bus_block[interior], bus_slot[interior]] = m_ang[interior]
    mask_int[bus_block[interior], ni + bus_slot[interior]] = m_mag[interior]
    mask_bdr = np.concatenate([m_ang[border], m_mag[border]])

    return dict(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        yg=yg_host, yb=yb_host, diag=np.asarray(diag, dtype=np.int32),
        bus_type=types, slack=slack,
        p_sched=bus.supply.active.array[:n] - bus.demand.active.array[:n],
        q_sched=(bus.supply.reactive.array[:n]
                 - bus.demand.reactive.array[:n]),
        ii_sel=ii[0], ii_blk=ii[1], ii_row=ii[2], ii_col=ii[3],
        ib_sel=ib[0], ib_blk=ib[1], ib_row=ib[2], ib_col=ib[3],
        bi_sel=bi[0], bi_blk=bi[1], bi_row=bi[2], bi_col=bi[3],
        bb_sel=bb[0], bb_row=bb[2], bb_col=bb[3],
        bus_block=bus_block.astype(np.int32),
        bus_slot=bus_slot.astype(np.int32),
        mask_int=mask_int, mask_bdr=mask_bdr, bsel=bsel, bmask=bmask)


def compile_nr_bbd(system: PowerSystem, n_blocks: int, device=None):
    """``(NrBbdArrays, _BbdLayout)`` on ``device`` (default
    ``config.device``)."""
    # convert.py builds NrBbdArrays from numpy and imports this module
    from ..convert import nr_bbd_arrays_from_numpy
    model(system, "ac")
    return nr_bbd_arrays_from_numpy(**nr_bbd_tables(system, n_blocks),
                                    device=device)


def _quadrant_values(arr: AcArrays, vm, va, p, q):
    """Per-entry H/N/J/L values, concatenated (4*nnz,), at ``(vm, va)``
    with the injections ``p``, ``q``: the plain version of K1's routed mode
    (the JAX package's ``_quadrant_values``)."""
    rows, cols = arr.rows.long(), arr.cols.long()
    vi = vm[rows]
    vj = vm[cols]
    th = va[rows] - va[cols]
    sin_t = torch.sin(th)
    cos_t = torch.cos(th)
    gc_bs = arr.yg * cos_t + arr.yb * sin_t
    gs_bc = arr.yg * sin_t - arr.yb * cos_t

    # the diagonal entries of the pattern (where the per-entry yg/yb ARE
    # Gii/Bii) carry the bus's diagonal terms
    off = rows != cols
    h = torch.where(off, vi * vj * gs_bc, -q[rows] - arr.yb * vi ** 2)
    nn = torch.where(off, vi * gc_bs, p[rows] / vi + arr.yg * vi)
    jj = torch.where(off, -vi * vj * gc_bs, p[rows] - arr.yg * vi ** 2)
    ll = torch.where(off, vi * gs_bc, q[rows] / vi - arr.yb * vi)
    return torch.cat([h, nn, jj, ll])


def _blocks(buf, layout: _BbdLayout):
    """Views of K1's routed buffer: a_ii, a_ib, a_bi, a_bb."""
    k, n2i, n2l, nbr = (layout.k, 2 * layout.ni, 2 * layout.mbl,
                        2 * layout.mb)
    s_ii, s_ib = k * n2i * n2i, k * n2i * n2l
    return (buf[:s_ii].view(k, n2i, n2i),
            buf[s_ii:s_ii + s_ib].view(k, n2i, n2l),
            buf[s_ii + s_ib:s_ii + 2 * s_ib].view(k, n2l, n2i),
            buf[s_ii + 2 * s_ib:].view(nbr, nbr))


def _nr_bbd_update(arr: NrBbdArrays, layout: _BbdLayout, vm, va, res):
    """The Newton step from K1's routed output ``res`` at ``(vm, va)``."""
    a_ii, a_ib, a_bi, a_bb = _blocks(res.buf, layout)
    # right-hand side in the block layout; K1's mismatch is already zero at
    # the slack angle and off PQ magnitudes, the padded slots stay zero
    mark("rhs")
    r = vm.new_zeros(layout.k * 2 * layout.ni + 2 * layout.mb)
    r[arr.var_pos[0]] = res.mp
    r[arr.var_pos[1]] = res.mq
    n_int = layout.k * 2 * layout.ni
    y, z = linalg.batched_lu_solve2(a_ii, r[:n_int].view(layout.k, -1), a_ib)
    mark("Schur products")
    contrib, parts = a_bi @ z, _vec(a_bi, y)
    mark("K5")
    schur, rhs_b = schur_gather(arr.schur, contrib, parts, a_bb, r[n_int:],
                                scale=-1.0)
    mark("border LU")
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU), rhs_b)
    mark("back-sub")
    x_i = y - _vec(z, local_border(x_b, arr.bsel, arr.bmask))
    x = torch.cat([x_i.reshape(-1), x_b])
    net = arr.net
    not_slack = torch.arange(vm.shape[0], device=vm.device) != net.slack
    is_pq = net.bus_type == 1
    va_new = va - torch.where(not_slack, x[arr.var_pos[0]], 0.0)
    vm_new = vm - torch.where(is_pq, x[arr.var_pos[1]], 0.0)
    return vm_new, va_new


def _nr_bbd_step(arr: NrBbdArrays, layout: _BbdLayout, vm, va):
    """One BBD Newton step from ``(vm, va)``: one routed K1 launch, then
    the Schur solve."""
    res = nr_fill_routed(arr.net, arr.route, vm, va)
    return _nr_bbd_update(arr, layout, vm, va, res)


def _nr_bbd_solve(arr: NrBbdArrays, layout: _BbdLayout, vm, va, tol: float,
                  max_iter: int):
    """Full BBD NR loop: one routed K1 launch (mismatch and blocks at the
    current state) and one scalar-pair readback per iteration, then the
    step. Check-then-step, as the JAX package's while loop
    (newton_bbd.py:369-386): the count equals the number of steps, and
    convergence is judged on the freshly recomputed mismatch. The device
    stages are marked for ``utils.profiling.device_stages``."""
    mark("fill")
    res = nr_fill_routed(arr.net, arr.route, vm, va)
    it = 0
    while True:
        mark("readback")
        del_p, del_q = torch.stack([res.mp.abs().amax(),
                                    res.mq.abs().amax()]).tolist()
        converged = del_p < tol and del_q < tol
        if converged or it >= max_iter:
            break
        vm, va = _nr_bbd_update(arr, layout, vm, va, res)
        it += 1
        mark("fill")
        res = nr_fill_routed(arr.net, arr.route, vm, va)
    mark(None)
    return vm, va, it, del_p, del_q, converged


def newton_raphson_bbd(system: PowerSystem, n_blocks: int = 4,
                       device=None) -> AcPowerFlow:
    """NR power flow with the BBD/Schur linear-solver substrate, on
    ``device`` (default ``config.device``)."""
    device = resolve_device(device)
    system.check_slack()
    model(system, "ac")
    magnitude, angle = initialize_ac_power_flow(system)
    arrays, layout = compile_nr_bbd(system, n_blocks, device)
    rev = system.model.revision
    analysis = AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState("newton_raphson_bbd"),
        arrays=arrays,
        device=device,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )
    analysis._bbd_layout = layout
    analysis._bbd_n_blocks = n_blocks
    return analysis


def power_flow_bbd(analysis: AcPowerFlow, iteration: int = 20,
                   tolerance: float = 1e-8):
    """Driver for the BBD NR analysis."""
    analysis._refresh_arrays()
    vm, va = analysis._state()
    vm, va, it, del_p, del_q, conv = _nr_bbd_solve(
        analysis.arrays, analysis._bbd_layout, vm, va, tolerance, iteration)
    analysis.voltage.magnitude = vm.cpu().numpy()
    analysis.voltage.angle = va.cpu().numpy()
    analysis.method.iteration = it
    analysis.method.converged = conv
    analysis.method.max_mismatch_active = del_p
    analysis.method.max_mismatch_reactive = del_q
    return analysis
