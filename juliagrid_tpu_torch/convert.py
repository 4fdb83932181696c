"""Network and measurement state carried across: numpy arrays to the port's
device snapshots.

``ac_arrays_from_numpy`` takes the fields of an ``AcArrays`` as numpy arrays
— from the port's own host layer, or ``np.asarray`` of each field of the JAX
package's ``AcArrays`` — and places them on a torch device with the CSR row
offsets and the Newton system's variable map K1 needs.
``dc_arrays_from_numpy``, ``fnr_arrays_from_numpy`` and
``gs_arrays_from_numpy`` do the same for the ``DcArrays``, ``FnrArrays``
(whose masked B' and B'' they factor in f64) and ``GsArrays`` (to which they
add the PQ and PV bus lists of the sequential sweep and K4's level
schedule). ``se_arrays_from_numpy`` does the same for the measurement-row
IR: it takes an ``SeArrays`` host mirror (the port's, or the JAX package's
from ``compile_se_arrays(..., return_host=True)``) and adds K3's descriptor
table. ``nr_bbd_arrays_from_numpy`` and ``se_bbd_arrays_from_numpy`` take
the routing tables of the JAX package's ``NrBbdArrays`` and ``SeBbdArrays``
(under their field names) and derive from them what the port's BBD paths
read: K1's and K3's routed-mode tables, K5's gather tables and each bus's
place in the block layout. ``dcse_arrays_from_numpy`` and
``pmuse_arrays_from_numpy`` take the fields of the JAX package's
``DcSeArrays`` and ``PmuSeArrays`` (dense H included) for the linear
estimators. Feeding both packages the same arrays lets a test compare their
kernels and solves without going through either host layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .estimation.acse import BranchGroup, SeArrays
from .estimation.dcse import DcSeArrays
from .estimation.pmuse import PmuSeArrays
from .kernels.nr_fill import NrRoute, check_route
from .kernels.schur_gather import schur_route
from .kernels.se_fill import (SeFillTable, SeRoute, entry_positions,
                               row_classes, se_fill_table, slot_rows)
from .ops import linalg
from .powerflow.ac import AcArrays, check_entry_list, newton_unknowns
from .powerflow.dc import DcArrays
from .powerflow.fast_decoupled import FnrArrays
from .powerflow.gauss_seidel import GsArrays, level_schedule, row_counts
from .utils.profiling import default_timings


def ac_arrays_from_numpy(*, rows, cols, yg, yb, diag, bus_type, slack,
                         p_sched, q_sched, device=None) -> AcArrays:
    """``AcArrays`` on ``device`` (default ``config.device``) from numpy,
    with the CSR row offsets and the Newton system's variable map
    (``newton_unknowns``) built here on the host."""
    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    diag = np.asarray(diag, dtype=np.int32)
    n = len(p_sched)
    check_entry_list(rows, cols, diag, n)
    row_ptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)
    pos, unknowns = newton_unknowns(bus_type, int(slack))

    def i32(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)

    def f64(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    return AcArrays(rows=i32(rows), cols=i32(cols), yg=f64(yg), yb=f64(yb),
                    diag=i32(diag), bus_type=i32(bus_type), slack=int(slack),
                    p_sched=f64(p_sched), q_sched=f64(q_sched),
                    row_ptr=i32(row_ptr), pos=i32(pos),
                    unknowns=torch.tensor(unknowns, device=dev),
                    order=len(unknowns))


def dc_arrays_from_numpy(*, b_dense, slack, p_sched, shift, gshunt,
                         slack_angle, device=None) -> DcArrays:
    """``DcArrays`` on ``device`` (default ``config.device``) from numpy
    (``b_dense`` may already be a tensor on that device)."""
    dev = resolve_device(device)

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    return DcArrays(
        b_dense=torch.as_tensor(b_dense, dtype=torch.float64, device=dev),
        slack=int(slack), p_sched=f64(p_sched), shift=f64(shift),
        gshunt=f64(gshunt), slack_angle=float(slack_angle))


def fnr_arrays(base: AcArrays, bp: torch.Tensor,
               bq: torch.Tensor) -> FnrArrays:
    """``FnrArrays`` of the network ``base`` and the masked B' and B'' on
    its device, each factored once in f64 (of ``base``, the fields K1 reads
    without the Jacobian: FDPF takes no Newton system's map)."""
    fields = {f: getattr(base, f) for f in FnrArrays._fields[:-2]}
    return FnrArrays(**fields, bp=linalg.factorize(bp, linalg.LU),
                     bq=linalg.factorize(bq, linalg.LU))


def fnr_arrays_from_numpy(*, rows, cols, yg, yb, diag, bus_type, slack,
                          p_sched, q_sched, bp_a64, bq_a64,
                          device=None) -> FnrArrays:
    """``FnrArrays`` on ``device`` (default ``config.device``) from the
    numpy fields of the JAX package's ``FnrArrays``: its network and its
    f64 masked B' (``bp_a64``) and B'' (``bq_a64``), which are factored
    here in f64 (the JAX package's f32 factors are not taken)."""
    base = ac_arrays_from_numpy(
        rows=rows, cols=cols, yg=yg, yb=yb, diag=diag, bus_type=bus_type,
        slack=slack, p_sched=p_sched, q_sched=q_sched, device=device)
    dev = base.cols.device
    return fnr_arrays(
        base, torch.tensor(np.asarray(bp_a64, dtype=np.float64), device=dev),
        torch.tensor(np.asarray(bq_a64, dtype=np.float64), device=dev))


def gs_arrays_from_numpy(*, nb, yre, yim, dre, dim, bus_type, slack,
                         p_sched, q_sched, vg, device=None) -> GsArrays:
    """``GsArrays`` on ``device`` (default ``config.device``) from numpy,
    with the ascending PQ and PV bus lists of the sequential sweep and the
    level schedule K4 walks (``gauss_seidel.level_schedule``)."""
    dev = resolve_device(device)
    bus_type = np.asarray(bus_type, dtype=np.int32)
    counts = row_counts(nb)
    pq_order, pq_ptr = level_schedule(nb, counts, bus_type, 1)
    pv_order, pv_ptr = level_schedule(nb, counts, bus_type, 2)

    def i32(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)

    def f64(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    return GsArrays(
        nb=i32(nb), yre=f64(yre), yim=f64(yim), dre=f64(dre), dim=f64(dim),
        bus_type=i32(bus_type), slack=int(slack), p_sched=f64(p_sched),
        q_sched=f64(q_sched), vg=f64(vg),
        pq=i32(np.flatnonzero(bus_type == 1)),
        pv=i32(np.flatnonzero(bus_type == 2)),
        pq_order=i32(pq_order), pq_ptr=i32(pq_ptr),
        pv_order=i32(pv_order), pv_ptr=i32(pv_ptr),
        widest=int(max(np.diff(pq_ptr).max(initial=0),
                       np.diff(pv_ptr).max(initial=0))))


def _f64(a, dev) -> torch.Tensor:
    """An f64 tensor on ``dev``: a tensor moved there, or a numpy array
    copied there."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float64)
    return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)


def dcse_arrays_from_numpy(*, h_dense, mean, w, slack, slack_angle,
                           device=None) -> DcSeArrays:
    """``DcSeArrays`` on ``device`` (default ``config.device``) from the
    numpy fields of a ``DcSeArrays`` (``h_dense`` may already be a tensor
    on that device)."""
    dev = resolve_device(device)
    return DcSeArrays(
        h_dense=_f64(h_dense, dev), mean=_f64(mean, dev), w=_f64(w, dev),
        slack=int(slack), slack_angle=float(slack_angle))


def pmuse_arrays_from_numpy(*, h_dense, mean, w, pair_r1, pair_r2, pair_off,
                            device=None) -> PmuSeArrays:
    """``PmuSeArrays`` on ``device`` (default ``config.device``) from the
    numpy fields of a ``PmuSeArrays`` (``h_dense`` may already be a tensor
    on that device); the pair indices become int64."""
    dev = resolve_device(device)

    def i64(a):
        return torch.tensor(np.asarray(a, dtype=np.int64), device=dev)

    return PmuSeArrays(
        h_dense=_f64(h_dense, dev), mean=_f64(mean, dev), w=_f64(w, dev),
        pair_r1=i64(pair_r1), pair_r2=i64(pair_r2),
        pair_off=_f64(pair_off, dev))


def se_arrays_from_numpy(host, device=None) -> SeArrays:
    """``SeArrays`` on ``device`` (default ``config.device``), with K3's
    descriptor table, from a host mirror whose fields are numpy arrays.
    Index fields become int64 tensors; the table is checked on the host
    (``se_fill_table``, ``entry_positions``) before it reaches K3; their
    build is the span ``tables.build`` of
    ``utils.profiling.default_timings``."""
    dev = resolve_device(device)
    with default_timings.span("tables.build"):
        idx, coef = se_fill_table(host)
        order, closed = row_classes(idx)
        epos, entries = entry_positions(host)

    def i64(a):
        return torch.tensor(np.asarray(a, dtype=np.int64), device=dev)

    def f64(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    branch = tuple(BranchGroup(rows=i64(g.rows), f=i64(g.f), t=i64(g.t),
                               a=f64(g.a), b=f64(g.b), c=f64(g.c),
                               d=f64(g.d), phi=f64(g.phi))
                   for g in host.branch)
    index = {name: i64(getattr(host, name)) for name in (
        "pair_r1", "pair_r2", "vm_rows", "vm_bus", "va_rows", "va_bus",
        "rev_rows", "rev_bus", "imv_rows", "imv_bus", "p_rows", "p_bus",
        "p_ent_meas", "p_ent_k", "q_rows", "q_bus", "q_ent_meas",
        "q_ent_k")}
    return SeArrays(
        mean=f64(host.mean), w=f64(host.w), status=f64(host.status),
        pair_off=f64(host.pair_off), slack=int(host.slack), branch=branch,
        desc=SeFillTable(
            idx=torch.tensor(idx, device=dev),
            coef=torch.tensor(coef, device=dev),
            order=torch.tensor(order, device=dev), closed=closed,
            epos=torch.tensor(epos, device=dev), entries=entries),
        **index)


def _var_pos(bus_block, bus_slot, k: int, ni: int, mb: int) -> np.ndarray:
    """``[2, n]`` flat positions of each bus's θ and V variables in the
    block layout ``[k 2ni | 2mb]``: interior slot s of block b at
    ``2ni b + s`` (V: ``+ ni``), border slot q at ``2ni k + q`` (V:
    ``+ mb``)."""
    bus_block = np.asarray(bus_block, dtype=np.int64)
    bus_slot = np.asarray(bus_slot, dtype=np.int64)
    interior = bus_block >= 0
    ang = np.where(interior, 2 * ni * bus_block + bus_slot,
                   2 * ni * k + bus_slot)
    return np.stack([ang, ang + np.where(interior, ni, mb)])


def nr_bbd_arrays_from_numpy(*, rows, cols, yg, yb, diag, bus_type, slack,
                             p_sched, q_sched, ii_sel, ii_blk, ii_row,
                             ii_col, ib_sel, ib_blk, ib_row, ib_col, bi_sel,
                             bi_blk, bi_row, bi_col, bb_sel, bb_row, bb_col,
                             bus_block, bus_slot, mask_int, mask_bdr, bsel,
                             bmask, device=None):
    """``(NrBbdArrays, _BbdLayout)`` on ``device`` (default
    ``config.device``) from the numpy fields of an ``NrBbdArrays`` of the
    JAX package (or ``newton_bbd.nr_bbd_tables``).

    The four routing families become K1's routed offsets into one flat
    buffer ``a_ii | a_ib | a_bi | a_bb``, with every value whose row or
    column variable is masked dropped (-1) and the masked and padded
    variables' diagonal positions listed for 1.0 — the family masks of the
    JAX package's ``_nr_bbd_step`` (:308-319). Raises unless every
    destination has one writer (``check_route``)."""
    from .powerflow.newton_bbd import NrBbdArrays, _BbdLayout
    dev = resolve_device(device)
    net = ac_arrays_from_numpy(
        rows=rows, cols=cols, yg=yg, yb=yb, diag=diag, bus_type=bus_type,
        slack=slack, p_sched=p_sched, q_sched=q_sched, device=dev)
    mask_int = np.asarray(mask_int, dtype=np.float64)
    mask_bdr = np.asarray(mask_bdr, dtype=np.float64)
    bsel = np.asarray(bsel, dtype=np.int64)
    bmask = np.asarray(bmask, dtype=np.float64)
    k, n2i = mask_int.shape
    nbr, n2l = len(mask_bdr), bsel.shape[1]
    layout = _BbdLayout(k=k, ni=n2i // 2, mb=nbr // 2, mbl=n2l // 2)
    s_ii, s_ib = k * n2i * n2i, k * n2i * n2l
    size = s_ii + 2 * s_ib + nbr * nbr
    mloc = np.append(mask_bdr, 0.0)[bsel] * bmask

    nnz = len(rows)
    off = np.full(4 * nnz, -1, dtype=np.int64)

    def route(sel, keep, flat):
        sel = np.asarray(sel, dtype=np.int64)
        off[sel[keep != 0]] = flat[keep != 0]

    b, r, c = (np.asarray(x, dtype=np.int64) for x in (ii_blk, ii_row,
                                                        ii_col))
    route(ii_sel, mask_int[b, r] * mask_int[b, c], (b * n2i + r) * n2i + c)
    b, r, c = (np.asarray(x, dtype=np.int64) for x in (ib_blk, ib_row,
                                                        ib_col))
    route(ib_sel, mask_int[b, r] * mloc[b, c],
          s_ii + (b * n2i + r) * n2l + c)
    b, r, c = (np.asarray(x, dtype=np.int64) for x in (bi_blk, bi_row,
                                                        bi_col))
    route(bi_sel, mloc[b, r] * mask_int[b, c],
          s_ii + s_ib + (b * n2l + r) * n2i + c)
    r, c = (np.asarray(x, dtype=np.int64) for x in (bb_row, bb_col))
    route(bb_sel, mask_bdr[r] * mask_bdr[c],
          s_ii + 2 * s_ib + r * nbr + c)
    off = off.reshape(4, nnz)

    b, i = np.nonzero(mask_int == 0)
    q = np.flatnonzero(mask_bdr == 0)
    ones = np.concatenate([(b * n2i + i) * n2i + i,
                           s_ii + 2 * s_ib + q * nbr + q])
    check_route(off, ones, size)

    def i64(a):
        return torch.tensor(np.ascontiguousarray(a, dtype=np.int64),
                            device=dev)

    arrays = NrBbdArrays(
        net=net, route=NrRoute(off=i64(off), ones=i64(ones), size=size),
        var_pos=i64(_var_pos(bus_block, bus_slot, k, layout.ni, layout.mb)),
        bsel=i64(bsel), bmask=torch.tensor(bmask, device=dev),
        schur=schur_route(bsel, nbr, dev))
    return arrays, layout


def se_bbd_arrays_from_numpy(*, base, net, ent_rows, hi_sel, hi_blk, hi_row,
                             hi_col, hb_sel, hb_blk, hb_row, hb_col,
                             rows_idx, row_mask, lb_gidx, bus_block,
                             bus_slot, mask_int, mask_bdr, device=None):
    """``(SeBbdArrays, _SeBbdLayout)`` on ``device`` (default
    ``config.device``) from the routing tables of an ``SeBbdArrays`` of
    the JAX package (or ``acse_bbd.se_bbd_tables``) as numpy arrays.
    ``base`` is an ``SeArrays`` on the device or a host mirror of one;
    ``net`` an ``AcArrays`` on the device or a mapping of its numpy fields.

    From the row routing come K3's row maps (block and slot of each row,
    and their inverse, the row on each slot of each block), from the bus
    routing and ``lb_gidx`` its column map (each block's
    angle column of each of its buses), and from ``lb_gidx`` K5's per-slot
    lists. The JAX package's per-block padded entry tables (``pb_*``)
    serve its per-block streaming only and are not taken."""
    from .estimation.acse_bbd import SeBbdArrays, _SeBbdLayout
    dev = resolve_device(device)
    if not isinstance(base.mean, torch.Tensor):
        base = se_arrays_from_numpy(base, dev)
    if not isinstance(net, AcArrays):
        net = ac_arrays_from_numpy(device=dev, **net)
    mask_int = np.asarray(mask_int, dtype=np.float64)
    mask_bdr = np.asarray(mask_bdr, dtype=np.float64)
    rows_idx = np.asarray(rows_idx, dtype=np.int64)
    lb_gidx = np.asarray(lb_gidx, dtype=np.int64)
    bus_block = np.asarray(bus_block, dtype=np.int64)
    bus_slot = np.asarray(bus_slot, dtype=np.int64)
    k, n2i = mask_int.shape
    layout = _SeBbdLayout(k=k, ni=n2i // 2, mb=len(mask_bdr) // 2,
                          mr=rows_idx.shape[1], lb=lb_gidx.shape[1] // 2)
    m, n = int(base.mean.shape[0]), len(bus_block)

    row_block = np.full(m, -1, dtype=np.int64)
    row_slot = np.zeros(m, dtype=np.int64)
    blk, slot = np.nonzero(np.asarray(row_mask) != 0)
    row_block[rows_idx[blk, slot]] = blk
    row_slot[rows_idx[blk, slot]] = slot
    if np.any(row_block < 0):
        raise ValueError("a measurement row belongs to no block")
    slot_row = slot_rows(row_block, row_slot, k, layout.mr)

    colmap = np.full((k, n), -1, dtype=np.int64)
    interior = np.flatnonzero(bus_block >= 0)
    colmap[bus_block[interior], interior] = bus_slot[interior]
    border_bus = np.zeros(int(np.sum(bus_block < 0)), dtype=np.int64)
    border_bus[bus_slot[bus_block < 0]] = np.flatnonzero(bus_block < 0)
    blk, slot = np.nonzero(lb_gidx[:, :layout.lb] < len(border_bus))
    colmap[blk, border_bus[lb_gidx[blk, slot]]] = n2i + slot

    def i64(a):
        return torch.tensor(np.asarray(a, dtype=np.int64), device=dev)

    def i32(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)

    route = SeRoute(
        row_block=i32(row_block), row_slot=i32(row_slot),
        slot_row=i32(slot_row), colmap=i32(colmap),
        ent_rows=i64(ent_rows), hi_sel=i64(hi_sel), hi_blk=i64(hi_blk),
        hi_row=i64(hi_row), hi_col=i64(hi_col), hb_sel=i64(hb_sel),
        hb_blk=i64(hb_blk), hb_row=i64(hb_row), hb_col=i64(hb_col),
        mask_int=torch.tensor(mask_int, device=dev),
        mask_lb=torch.tensor(np.append(mask_bdr, 0.0)[lb_gidx], device=dev),
        mr=layout.mr, ni=layout.ni, lb=layout.lb)
    arrays = SeBbdArrays(
        base=base, net=net, route=route, rows_idx=i64(rows_idx),
        row_mask=torch.tensor(np.asarray(row_mask, dtype=np.float64),
                              device=dev),
        lb_gidx=i64(lb_gidx),
        var_pos=i64(_var_pos(bus_block, bus_slot, k, layout.ni, layout.mb)),
        mask_int=torch.tensor(mask_int, device=dev),
        mask_bdr=torch.tensor(mask_bdr, device=dev),
        schur=schur_route(lb_gidx, len(mask_bdr), dev))
    return arrays, layout


def dcopf_arrays_from_numpy(spec, device=None, b_dense=None):
    """``DcOpfArrays`` on ``device`` (default ``config.device``) from the
    host lists of a DC OPF spec: the port's ``opf/dcopf._DcSpec`` or the
    JAX package's (same fields; its ``b_dense``, ``rhs`` and ``gen_bus``
    go through ``np.asarray``). B is ``b_dense`` when given, else scattered
    from the spec's DC nodal matrix (``nodal``) or copied from its dense
    ``b_dense``. The inequality rows follow the lists in the JAX package's
    emission order."""
    from .opf.dcopf import DcOpfArrays

    dev = resolve_device(device)
    n, g, n_h = int(spec.n), int(spec.g), int(spec.n_h)
    if b_dense is None:
        if hasattr(spec, "nodal"):
            coo = spec.nodal.tocoo()
            b_dense = linalg.dense_from_coo(coo.row, coo.col, coo.data, n,
                                            dev)
        else:
            b_dense = _f64(np.asarray(spec.b_dense), dev)
    gen_on = np.asarray(spec.gen_on, dtype=bool)

    # row r: a * (x[i1] - b * x[i2] - off) + c0 + e * x[i3]
    rows = []
    for i, lo in spec.cap_lo:
        rows.append((n + i, 0, 0, 1.0, 0.0, 0.0, -lo, 0.0))
    for i, hi in spec.cap_hi:
        rows.append((n + i, 0, 0, -1.0, 0.0, 0.0, hi, 0.0))
    for (f, t, adm, phi, lo, hi, _k) in spec.flows:
        if np.isfinite(lo):
            rows.append((f, t, 0, adm, 1.0, phi, -lo, 0.0))
        if np.isfinite(hi):
            rows.append((f, t, 0, -adm, 1.0, phi, hi, 0.0))
    for (f, t, lo, hi, _k) in spec.angles:
        rows.append((f, t, 0, 1.0, 1.0, 0.0, -lo, 0.0))
        rows.append((f, t, 0, -1.0, 1.0, 0.0, hi, 0.0))
    for (gi, hpos, slope, icept) in spec.pw_cuts:
        rows.append((n + gi, 0, n + g + hpos, -slope, 0.0, 0.0, icept, 1.0))
    tab = np.asarray(rows, dtype=np.float64).reshape(-1, 8)

    def i64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    fix = np.asarray(spec.fix_p, dtype=np.float64).reshape(-1, 2)
    return DcOpfArrays(
        b_dense=b_dense, rhs=_f64(np.asarray(spec.rhs), dev),
        gen_bus=i64(np.asarray(spec.gen_bus)),
        gen_on=torch.as_tensor(gen_on, device=dev),
        off_idx=i64(np.flatnonzero(~gen_on)), fix_idx=i64(fix[:, 0]),
        fix_val=_f64(fix[:, 1], dev),
        quad=_f64(spec.obj_quad, dev), lin=_f64(spec.obj_lin, dev),
        const=float(spec.obj_const),
        i1=i64(tab[:, 0]), i2=i64(tab[:, 1]), i3=i64(tab[:, 2]),
        a=_f64(tab[:, 3], dev), b=_f64(tab[:, 4], dev),
        off=_f64(tab[:, 5], dev), c0=_f64(tab[:, 6], dev),
        e=_f64(tab[:, 7], dev),
        n=n, g=g, n_h=n_h, slack=int(spec.slack),
        slack_angle=float(spec.slack_angle))


def acopf_arrays_from_numpy(spec, device=None):
    """``AcOpfArrays`` on ``device`` (default ``config.device``), with K6's
    tables checked and in ``fill``, from the lists of an AC OPF spec: the
    port's ``opf/acopf._AcSpec`` or the JAX package's (same fields; its
    ``rows``, ``cols`` and ``gen_bus`` go through ``np.asarray``)."""
    from .kernels.opf_fill import (check_fill_table, flow_admittances,
                                   opf_fill_table, opf_fill_table_tensors)
    from .opf.acopf import AcOpfArrays

    dev = resolve_device(device)
    n, g = int(spec.n), int(spec.g)
    rows = np.asarray(spec.rows, dtype=np.int64)
    cols = np.asarray(spec.cols, dtype=np.int64)
    tab = opf_fill_table(spec)
    check_fill_table(tab, rows, cols)

    def i64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    def f64(a):
        return _f64(np.asarray(a, dtype=np.float64), dev)

    gen_on = np.asarray(spec.gen_on, dtype=bool)
    poly = tuple(
        (i64((2 * n if kind == "p" else 2 * n + g) + np.asarray(idx)),
         f64(np.asarray(co).reshape(len(idx), -1)))
        for (kind, _deg), idx, co in zip(spec.poly_keys, spec.poly_idx,
                                         spec.poly_co))
    pwp, pwq = spec.pwp, spec.pwq
    return AcOpfArrays(
        rows=i64(rows), cols=i64(cols), yg=f64(spec.yg), yb=f64(spec.yb),
        pd=f64(spec.pd), qd=f64(spec.qd),
        gen_bus=i64(np.asarray(spec.gen_bus)),
        gen_on=torch.as_tensor(gen_on, device=dev),
        off_idx=i64(np.flatnonzero(~gen_on)),
        fixv_i=i64(spec.fixv_i), fixv_b=f64(spec.fixv_b),
        fixp_i=i64(spec.fixp_i), fixp_b=f64(spec.fixp_b),
        fixq_i=i64(spec.fixq_i), fixq_b=f64(spec.fixq_b),
        vlo_i=i64(spec.vlo_i), vlo_b=f64(spec.vlo_b),
        vhi_i=i64(spec.vhi_i), vhi_b=f64(spec.vhi_b),
        plo_i=i64(spec.plo_i), plo_b=f64(spec.plo_b),
        phi_i=i64(spec.phi_i), phi_b=f64(spec.phi_b),
        qlo_i=i64(spec.qlo_i), qlo_b=f64(spec.qlo_b),
        qhi_i=i64(spec.qhi_i), qhi_b=f64(spec.qhi_b),
        cc_i=i64(spec.cc_i), cc_aq=f64(spec.cc_aq), cc_ap=f64(spec.cc_ap),
        cc_b=f64(spec.cc_b),
        fl_fb=i64(spec.fl_fb), fl_tb=i64(spec.fl_tb),
        fl_from=torch.as_tensor(np.asarray(spec.fl_from, dtype=bool),
                                device=dev),
        fl_cls=i64(spec.fl_cls), fl_y=f64(flow_admittances(spec)),
        fl_lo=f64(spec.fl_lo), fl_hi=f64(spec.fl_hi),
        fl_lo_sel=i64(np.flatnonzero(np.asarray(spec.fl_has_lo, dtype=bool))),
        fl_hi_sel=i64(np.flatnonzero(np.asarray(spec.fl_has_hi, dtype=bool))),
        an_f=i64(spec.an_f), an_t=i64(spec.an_t), an_lo=f64(spec.an_lo),
        an_hi=f64(spec.an_hi),
        pwp_gi=i64(pwp[0]), pwp_hpos=i64(pwp[1]), pwp_slope=f64(pwp[2]),
        pwp_icept=f64(pwp[3]),
        pwq_gi=i64(pwq[0]), pwq_hpos=i64(pwq[1]), pwq_slope=f64(pwq[2]),
        pwq_icept=f64(pwq[3]),
        poly=poly, fill=opf_fill_table_tensors(tab, spec, dev),
        obj_const=float(spec.obj_const),
        slack_angle=float(spec.slack_angle), n=n, g=g,
        n_hp=int(spec.n_hp), n_hq=int(spec.n_hq), n_x=int(spec.n_x),
        m_e=int(spec.m_e), m_i=int(spec.m_i), slack=int(spec.slack))
