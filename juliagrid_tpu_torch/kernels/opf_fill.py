"""K6 ``opf_fill``: the AC OPF's constraint Jacobians and Lagrangian Hessian.

One launch computes, at one point ``x`` of an AC OPF spec, what
``juliagrid_tpu/opf/acopf.py`` computes in ``jac_eq`` (:693) and
``jac_ineq`` with ``_flow_grads`` (:748-800) — Jacobian mode, J_E
``[m_E, n_x]`` and J_I ``[m_I, n_x]`` — or, given the duals ``y`` and
``z``, in ``hess`` with ``_flow_row_val`` (:802-921) — Hessian mode, the
raw Lagrangian Hessian ``[n_x, n_x]``. The outputs are dense row-major f64
matrices, zeros included, written in the one launch. The CUDA source, its
mapping and what bounds it are described in ``csrc/opf_fill.cu``.

The kernel reads ``OpfFillTable``, which ``opf_fill_table`` builds on the
host from the lists of an AC OPF spec (the port's ``opf/acopf._AcSpec`` or
the JAX package's) and ``check_fill_table`` holds to the rule that gives
every output element one writer: each bus's Y-bus row, generator list and
pair list (the buses it shares a Y-bus entry or a flow row with) name each
column once, every Y-bus entry and every flow row is listed once at each of
its ends, and every other row has its own descriptor. The Hessian mode
streams its rows through shared-memory windows by the plan ``hess_plan``
(also in the tables): ``check_fill_table`` holds its windows to covering
every element of H once.

``opf_fill`` dispatches on the device of ``x``: a CUDA tensor goes to the
kernel (the call raises if it does not build or launch), a CPU tensor to
``opf_fill_ref``, the plain PyTorch transcription of the JAX package's
functions, whose flow rows take ``torch.func`` ``grad``/``hessian`` of
``flow_row_value``. ``opf_fill.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, vmap
from torch.utils.weak import WeakIdKeyDictionary

from . import _build

#: descriptor kinds of the rows after the balance rows (Jacobian mode)
LINEAR, FLOW = 0, 1
#: the Hessian mode's largest window, in doubles, and most tail rows a
#: thread block (``kWindow``, ``kTailRoom`` of csrc/opf_fill.cu); a block
#: stores about one window's worth of rows, and the value groups are about
#: HESS_VALUE_BLOCKS: at case1354pegase on the H100 the 619 groups and 260
#: tail units start in the first wave of 924 blocks (0.040 ms a Hessian;
#: 0.042-0.053 with 145-310 or 713-1,130 groups, PERF.md)
HESS_WINDOW, HESS_TAIL_ROOM, HESS_VALUE_BLOCKS = 8192, 64, 512
#: a value group's flow entries, pair slots and buses that fit its block's
#: shared memory (``kFlowRoom``, ``kSlotRoom``, ``kBusRoom``)
HESS_FLOW_ROOM, HESS_SLOT_ROOM, HESS_BUS_ROOM = 48, 40, 32
#: the Hessian mode's scratch, for value groups that outgrow shared memory:
#: doubles per flow entry of the pair lists and per pair slot
#: (``kFlowFields``, ``kSlotFields`` of csrc/opf_fill.cu)
SCRATCH_PER_FLOW, SCRATCH_PER_SLOT = 60, 12


class OpfFillTable(NamedTuple):
    """K6's tables (int32 and f64 tensors; structure of arrays)."""

    row_ptr: torch.Tensor    # [n + 1] the Y-bus entries of each bus's row
    ycol: torch.Tensor       # [nnz] their columns
    diag: torch.Tensor       # [n] each bus's diagonal entry, or -1
    gen_ptr: torch.Tensor    # [n + 1] each bus's generators ...
    gen_idx: torch.Tensor    # ... by index
    gen_on: torch.Tensor     # f64[g] 1 in service, 0 out
    row_kind: torch.Tensor   # [R] rows 2n.. of [J_E; J_I]: LINEAR or FLOW
    row_col: torch.Tensor    # [2, R] LINEAR: two columns (-1: none);
    row_val: torch.Tensor    # f64[2, R] and their values. FLOW: the flow
    #                          row in row_col[0], its sign in row_val[0]
    fl_idx: torch.Tensor     # [6, F] from bus, to bus, class, is-from,
    #                          its lower and upper row of J_I (-1: none)
    fl_y: torch.Tensor       # f64[4, F] gf, bf, gt, bt of the row's end
    pair_ptr: torch.Tensor   # [n + 1] each bus k's pair list, by bus j:
    pair: torch.Tensor       # [3, P] j, the entry (k, j), the entry (j, k)
    pair_fptr: torch.Tensor  # [P + 1] flow rows between k and j ...
    pair_flow: torch.Tensor  # ... in ascending order
    pf_idx: torch.Tensor     # [6, Q] fl_idx of each pair_flow entry
    pf_y: torch.Tensor       # f64[4, Q] fl_y of each pair_flow entry
    hess_group: torch.Tensor  # [6, G] the Hessian's value groups
    unit_group: torch.Tensor  # [U] each bus unit's value group
    item_at: torch.Tensor    # i64[4P + 4n] each slot's and bus's items'
    #                          elements of H (-1: none)
    term_ptr: torch.Tensor   # [n_x - 2n + 1] cost terms of each Pg/Qg/h
    term: torch.Tensor       # [2, T] degree, offset into term_co
    term_co: torch.Tensor    # f64 coefficients, descending powers
    hess_plan: tuple         # HessPlan: the Hessian mode's blocks and window
    n: int
    g: int
    n_x: int
    m_e: int
    m_i: int


class HessPlan(NamedTuple):
    """How the Hessian mode cuts H: ``bus_units`` consecutive buses a
    streaming block (their rows k.. and n + k..), ``row_units`` consecutive
    rows of 2n.. a tail block, each block's rows stored in windows of at
    most ``window`` doubles, cut at multiples of it; the values in
    ``groups`` value blocks (``hess_groups``)."""

    bus_units: int
    row_units: int
    window: int
    groups: int


class OpfFill(NamedTuple):
    jac_eq: Optional[torch.Tensor]    # [m_E, n_x] (Jacobian mode)
    jac_ineq: Optional[torch.Tensor]  # [m_I, n_x] (Jacobian mode)
    hess: Optional[torch.Tensor]      # [n_x, n_x] (Hessian mode)


def _csr(keys, size):
    """CSR offsets of ``keys`` (sorted, in [0, size))."""
    return np.searchsorted(np.asarray(keys, dtype=np.int64),
                           np.arange(size + 1)).astype(np.int32)


def opf_fill_table(spec) -> dict:
    """Numpy fields of ``OpfFillTable`` from the lists of an AC OPF spec
    (the port's or the JAX package's: the same field names). The rows after
    the balance rows follow the emission order of ``eq``/``ineq``."""
    n, g, n_x = int(spec.n), int(spec.g), int(spec.n_x)
    rows = np.asarray(spec.rows, dtype=np.int64)
    cols = np.asarray(spec.cols, dtype=np.int64)
    nnz = rows.size
    gen_bus = np.asarray(spec.gen_bus, dtype=np.int64)
    gen_on = np.asarray(spec.gen_on, dtype=bool)
    out = {}
    out["row_ptr"] = _csr(rows, n)
    out["ycol"] = cols.astype(np.int32)
    diag = np.full(n, -1, dtype=np.int64)
    on_diag = np.flatnonzero(rows == cols)
    diag[rows[on_diag]] = on_diag
    out["diag"] = diag.astype(np.int32)
    order = np.lexsort((np.arange(g), gen_bus))
    out["gen_ptr"] = _csr(gen_bus[order], n)
    out["gen_idx"] = order.astype(np.int32)
    out["gen_on"] = gen_on.astype(np.float64)

    # rows 2n.. of [J_E; J_I]: (kind, col1, col2, val1, val2)
    desc = []

    def linear(c1, v1, c2=None, v2=None):
        c1 = np.asarray(c1, dtype=np.int64)
        k = c1.size
        c2 = np.full(k, -1) if c2 is None else np.asarray(c2)
        v2 = np.zeros(k) if v2 is None else np.broadcast_to(v2, k)
        desc.append((np.full(k, LINEAR), c1, c2,
                     np.broadcast_to(np.asarray(v1, dtype=np.float64), k),
                     v2))

    slack = int(spec.slack)
    off = np.asarray(spec.gen_off, dtype=np.int64)
    linear([slack], 1.0)
    linear(2 * n + off, 1.0)
    linear(2 * n + g + off, 1.0)
    linear(n + np.asarray(spec.fixv_i, dtype=np.int64), 1.0)
    linear(2 * n + np.asarray(spec.fixp_i, dtype=np.int64), 1.0)
    linear(2 * n + g + np.asarray(spec.fixq_i, dtype=np.int64), 1.0)
    for idx, col0, sign in ((spec.vlo_i, n, 1.0), (spec.vhi_i, n, -1.0),
                            (spec.plo_i, 2 * n, 1.0),
                            (spec.phi_i, 2 * n, -1.0),
                            (spec.qlo_i, 2 * n + g, 1.0),
                            (spec.qhi_i, 2 * n + g, -1.0)):
        linear(col0 + np.asarray(idx, dtype=np.int64), sign)
    cc_i = np.asarray(spec.cc_i, dtype=np.int64)
    linear(2 * n + cc_i, -np.asarray(spec.cc_aq, dtype=np.float64),
           2 * n + g + cc_i, -np.asarray(spec.cc_ap, dtype=np.float64))
    has_lo = np.asarray(spec.fl_has_lo, dtype=bool)
    has_hi = np.asarray(spec.fl_has_hi, dtype=bool)
    n_fl = has_lo.size
    m_e = int(spec.m_e)
    lo_row = np.full(n_fl, -1, dtype=np.int64)
    hi_row = np.full(n_fl, -1, dtype=np.int64)
    r0 = 2 * n + sum(d[0].size for d in desc) - m_e   # first flow row of J_I
    for sel, sign, dest in ((np.flatnonzero(has_lo), 1.0, lo_row),
                            (np.flatnonzero(has_hi), -1.0, hi_row)):
        dest[sel] = r0 + np.arange(sel.size)
        r0 += sel.size
        desc.append((np.full(sel.size, FLOW), sel, np.full(sel.size, -1),
                     np.full(sel.size, sign), np.zeros(sel.size)))
    an_f = np.asarray(spec.an_f, dtype=np.int64)
    an_t = np.asarray(spec.an_t, dtype=np.int64)
    linear(an_f, 1.0, an_t, -1.0)
    linear(an_f, -1.0, an_t, 1.0)
    h0 = 2 * n + 2 * g
    for (gi, hpos, slope, _icept), col0, hcol0 in (
            (spec.pwp, 2 * n, h0), (spec.pwq, 2 * n + g, h0 + spec.n_hp)):
        linear(col0 + np.asarray(gi, dtype=np.int64),
               -np.asarray(slope, dtype=np.float64),
               hcol0 + np.asarray(hpos, dtype=np.int64), 1.0)
    kind, c1, c2, v1, v2 = (np.concatenate([d[i] for d in desc])
                            for i in range(5))
    out["row_kind"] = kind.astype(np.int32)
    out["row_col"] = np.stack([c1, c2]).astype(np.int32)
    out["row_val"] = np.stack([v1, v2]).astype(np.float64)

    fb = np.asarray(spec.fl_fb, dtype=np.int64)
    tb = np.asarray(spec.fl_tb, dtype=np.int64)
    is_from = np.asarray(spec.fl_from, dtype=bool)
    out["fl_idx"] = np.stack([
        fb, tb, np.asarray(spec.fl_cls, dtype=np.int64),
        is_from.astype(np.int64), lo_row, hi_row]).reshape(6, -1).astype(
            np.int32)
    out["fl_y"] = flow_admittances(spec)

    # each bus's pair list: the buses j it shares a Y-bus entry (either
    # way) or a flow row with, ascending, itself included where it has one
    fl_k1 = np.concatenate([fb, tb[fb != tb]])
    fl_k2 = np.concatenate([tb, fb[fb != tb]])
    fl_row = np.concatenate([np.arange(n_fl), np.flatnonzero(fb != tb)])
    keys = np.concatenate([rows * n + cols, cols * n + rows,
                           fl_k1 * n + fl_k2])
    pairs = np.unique(keys)
    pk, pj = pairs // n, pairs % n
    out["pair_ptr"] = _csr(pk, n)
    e_kj = np.full(pairs.size, -1, dtype=np.int64)
    e_jk = np.full(pairs.size, -1, dtype=np.int64)
    e_kj[np.searchsorted(pairs, rows * n + cols)] = np.arange(nnz)
    e_jk[np.searchsorted(pairs, cols * n + rows)] = np.arange(nnz)
    out["pair"] = np.stack([pj, e_kj, e_jk]).reshape(3, -1).astype(np.int32)
    slot = np.searchsorted(pairs, fl_k1 * n + fl_k2)
    order = np.lexsort((fl_row, slot))
    out["pair_fptr"] = _csr(slot[order], pairs.size)
    out["pair_flow"] = fl_row[order].astype(np.int32)
    # each entry's own copy of its flow row's descriptor: the Hessian mode
    # reads it in one step from the entry
    out["pf_idx"] = out["fl_idx"][:, out["pair_flow"]].reshape(6, -1)
    out["pf_y"] = out["fl_y"][:, out["pair_flow"]].reshape(4, -1)

    # the objective's second derivative: cost terms of degree >= 2 by
    # variable (rows 2n.. of H), each group in the order of poly_keys
    t_var, t_deg, t_co = [], [], []
    for (kind_pq, deg), idx, co in zip(spec.poly_keys, spec.poly_idx,
                                       spec.poly_co):
        if deg < 2:
            continue
        col0 = 0 if kind_pq == "p" else g
        for i, c in zip(np.asarray(idx), np.asarray(co, dtype=np.float64)):
            t_var.append(col0 + int(i))
            t_deg.append(deg)
            t_co.append(c)
    t_var = np.asarray(t_var, dtype=np.int64)
    order = np.argsort(t_var, kind="stable")
    co_list = [t_co[i] for i in order]
    lens = np.asarray([c.size for c in co_list], dtype=np.int64)
    out["term_ptr"] = _csr(t_var[order], n_x - 2 * n)
    out["term"] = np.stack([
        np.asarray(t_deg, dtype=np.int64)[order],
        np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        if lens.size else lens]).reshape(2, -1).astype(np.int32)
    out["term_co"] = (np.concatenate(co_list) if co_list
                      else np.zeros(0)).astype(np.float64)
    bus_units, row_units = hess_units(n, n_x)
    out["hess_group"], out["unit_group"] = hess_groups(
        out["pair_ptr"], out["pair_fptr"], n, bus_units)
    out["item_at"] = item_positions(out["pair_ptr"], out["pair"][0], n, n_x)
    out["hess_plan"] = np.asarray(
        [bus_units, row_units, HESS_WINDOW, out["hess_group"].shape[1]],
        dtype=np.int64)
    return out


def flow_admittances(spec) -> np.ndarray:
    """``[4, F]`` gf, bf, gt, bt of each flow row: the from-end two-port
    entries (yff, yft) of a from row, the to-end ones (ytf, ytt) of a to
    row, as the JAX package's ``where(is_from, ...)`` selects them."""
    k = np.asarray(spec.fl_k, dtype=np.int64)
    is_from = np.asarray(spec.fl_from, dtype=bool)
    yf = np.where(is_from, np.asarray(spec.br_yff)[k],
                  np.asarray(spec.br_ytf)[k])
    yt = np.where(is_from, np.asarray(spec.br_yft)[k],
                  np.asarray(spec.br_ytt)[k])
    return np.stack([yf.real, yf.imag, yt.real, yt.imag]).reshape(
        4, -1).astype(np.float64)


def hess_units(n: int, n_x: int, window: int = HESS_WINDOW) -> tuple:
    """The Hessian mode's buses a streaming block and rows of 2n.. a tail
    block for ``n`` buses and ``n_x`` variables: about a window of output a
    block (one bus's two rows, or two tail rows, at case1354pegase; every
    bus of case14 in one block)."""
    tail = n_x - 2 * n
    return (min(n, max(1, window // (2 * n_x))),
            min(max(tail, 1), HESS_TAIL_ROOM, max(1, window // n_x)))


def hess_groups(pair_ptr, pair_fptr, n: int, bus_units: int,
                blocks: int = HESS_VALUE_BLOCKS):
    """The Hessian mode's value groups: runs of consecutive bus units whose
    flow entries, slots and buses fit a block's shared memory (a unit too
    large for it is a group of its own) and whose work (16 per flow entry,
    one per slot and bus) stays near the total over ``blocks``. Returns
    ``[6, G]`` (first and end bus, slot and flow entry of each group) and
    each bus unit's group."""
    pair_ptr = np.asarray(pair_ptr, dtype=np.int64)
    pair_fptr = np.asarray(pair_fptr, dtype=np.int64)
    units = -(-n // bus_units)
    k = np.minimum(np.arange(units + 1) * bus_units, n)
    s = pair_ptr[k]
    q = pair_fptr[s]
    nq, ns, nb = np.diff(q), np.diff(s), np.diff(k)
    work = 16 * nq + ns + nb
    cap = max(1, -(-int(work.sum()) // blocks))
    starts, used = [0], np.zeros(4, dtype=np.int64)
    room = np.array([cap, HESS_FLOW_ROOM, HESS_SLOT_ROOM, HESS_BUS_ROOM])
    for u in range(units):
        add = np.array([work[u], nq[u], ns[u], nb[u]])
        if u > starts[-1] and np.any(used + add > room):
            starts.append(u)
            used[:] = 0
        used += add
    starts = np.asarray(starts + [units])
    first, end = starts[:-1], starts[1:]
    group = np.stack([k[first], k[end], s[first], s[end], q[first],
                      q[end]]).astype(np.int32)
    return group, np.repeat(np.arange(first.size), end - first).astype(
        np.int32)


def item_positions(pair_ptr, pair_j, n: int, n_x: int) -> np.ndarray:
    """Where the Hessian mode's items go (row-major elements of H): slot s
    of bus k with bus j, its four at 4 s + c, c = (theta_k, theta_j),
    (theta_k, V_j), (V_k, theta_j), (V_k, V_j), -1 for the slot (k, k);
    then bus k's four diagonal ones at 4P + 4 k + c."""
    pair_ptr = np.asarray(pair_ptr, dtype=np.int64)
    pj = np.asarray(pair_j, dtype=np.int64)
    pk = np.repeat(np.arange(n), np.diff(pair_ptr))
    k = np.arange(n)

    def four(rk, cj):
        return np.stack([rk * n_x + cj, rk * n_x + n + cj,
                         (n + rk) * n_x + cj, (n + rk) * n_x + n + cj], 1)

    slots = np.where((pj == pk)[:, None], -1, four(pk, pj))
    return np.concatenate([slots.reshape(-1),
                           four(k, k).reshape(-1)]).astype(np.int64)


def hess_blocks(plan, n: int, n_x: int) -> list:
    """``(kind, unit)`` of each thread block of the Hessian mode, in block
    order (csrc/opf_fill.cu::opf_hess_kernel): first the G value groups
    ``("value", i)`` (``hess_groups``; they store their buses' values) with
    the T' tail units ``("tail", i)`` (rows 2n + [i row_units, (i + 1)
    row_units)) spread evenly among them (block b is tail unit floor(b T' /
    (G + T')) when that count steps at b), then the U bus units ``("bus",
    i)``, which store the zeros of the rows of buses [i bus_units, (i + 1)
    bus_units) around the values (``item_positions``)."""
    bus_units, row_units, groups = int(plan[0]), int(plan[1]), int(plan[3])
    units = -(-n // bus_units)
    tails = -(-(n_x - 2 * n) // row_units)
    first = groups + tails
    out = []
    for t in range(first):
        before = t * tails // first
        if (t + 1) * tails // first > before:
            out.append(("tail", before))
        else:
            out.append(("value", t - before))
    return out + [("bus", i) for i in range(units)]


def hess_windows(plan, n: int, n_x: int):
    """Yield ``(block, first, last, base)`` for every window of the Hessian
    mode, in the kernel's order: the block, the absolute elements
    [first, last) of H (row-major) it stores, and the even element at which
    its bitmap of 16-byte chunks starts (aligned pairs from there)."""
    bus_units, row_units, window, _ = (int(v) for v in plan)
    spans = []
    for blk, (kind, i) in enumerate(hess_blocks(plan, n, n_x)):
        if kind == "value":
            continue
        if kind == "bus":
            k0, k1 = i * bus_units, min(n, (i + 1) * bus_units)
            spans += [(blk, k0 * n_x, k1 * n_x),
                      (blk, (n + k0) * n_x, (n + k1) * n_x)]
        else:
            r0 = 2 * n + i * row_units
            spans.append((blk, r0 * n_x, min(n_x, r0 + row_units) * n_x))
    for blk, first, last in spans:
        a = first
        while a < last:
            b = min(last, (a // window + 1) * window)
            yield blk, a, b, a & ~1
            a = b


def check_hess_plan(plan, n: int, n_x: int) -> None:
    """Raise unless the plan's windows fit the kernel's bitmap and tail
    rows its room, start their 16-byte stores on even elements, and cover
    every element of the ``n_x`` rows of H exactly once."""
    bus_units, row_units, window, groups = (int(v) for v in plan)
    if bus_units < 1 or groups < 1 or \
            not 1 <= row_units <= HESS_TAIL_ROOM or \
            window < 2 or window % 2 or window > HESS_WINDOW:
        raise ValueError(f"a Hessian plan needs units >= 1, at most "
                         f"{HESS_TAIL_ROOM} tail rows and an even window in "
                         f"[2, {HESS_WINDOW}], got {tuple(plan)}")
    wins = np.array([w[1:] for w in hess_windows(plan, n, n_x)],
                    dtype=np.int64).reshape(-1, 3)
    first, last, base = wins.T
    if np.any(base % 2) or np.any(base > first) or \
            np.any(last - base > window) or np.any(last <= first):
        raise ValueError("a Hessian window does not fit the bitmap from an "
                         "even element")
    order = np.argsort(first, kind="stable")
    first, last = first[order], last[order]
    if first.size == 0 or first[0] != 0 or last[-1] != n_x * n_x or \
            np.any(first[1:] != last[:-1]):
        raise ValueError("the Hessian windows do not cover every element of "
                         "H exactly once")


def check_fill_table(tab: dict, rows, cols) -> None:
    """Raise unless the tables give every element of J_E, J_I and H one
    writer: each bus's Y-bus row names a column once, each generator sits
    in one bus's list, each bus's pair list names a bus once and holds the
    Y-bus entries (k, j) and (j, k) it claims, every entry is claimed once
    from each end, every flow row is listed once at each of its ends (once
    if they are one bus), every descriptor names columns of the state,
    every cost term a coefficient run of its own, the Hessian plan's
    windows cover every element of H once (``check_hess_plan``), and its
    value groups run over the bus units in order."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    row_ptr = tab["row_ptr"].astype(np.int64)
    n = row_ptr.size - 1
    n_x = 2 * n + tab["term_ptr"].size - 1
    if np.any(np.diff(row_ptr) < 0) or row_ptr[-1] != rows.size or \
            np.any(rows != np.repeat(np.arange(n), np.diff(row_ptr))):
        raise ValueError("the Y-bus entries are not grouped by row")
    ycol = tab["ycol"].astype(np.int64)
    if np.unique(rows * n + ycol).size != rows.size:
        raise ValueError("a Y-bus row names a column twice")
    if ycol.size != cols.size or np.any(ycol != cols) or \
            np.any((cols < 0) | (cols >= n)):
        raise ValueError("the table's Y-bus columns are not the entry "
                         "list's, or lie outside the buses")
    gen_ptr = tab["gen_ptr"].astype(np.int64)
    gen_idx = tab["gen_idx"].astype(np.int64)
    if gen_ptr[-1] != tab["gen_on"].size or \
            np.unique(gen_idx).size != gen_idx.size:
        raise ValueError("every generator must sit in one bus's list")
    pair_ptr = tab["pair_ptr"].astype(np.int64)
    pj, e_kj, e_jk = tab["pair"].astype(np.int64)
    pk = np.repeat(np.arange(n), np.diff(pair_ptr))
    if pair_ptr[-1] != pj.size or np.unique(pk * n + pj).size != pj.size:
        raise ValueError("a bus's pair list names a bus twice")
    for e, want_r, want_c in ((e_kj, pk, pj), (e_jk, pj, pk)):
        has = e >= 0
        if np.any(rows[e[has]] != want_r[has]) or \
                np.any(cols[e[has]] != want_c[has]):
            raise ValueError("a pair slot claims a Y-bus entry of other "
                             "buses")
        if np.unique(e[has]).size != rows.size or has.sum() != rows.size:
            raise ValueError("every Y-bus entry must be claimed once from "
                             "each of its ends")
    fptr = tab["pair_fptr"].astype(np.int64)
    flow = tab["pair_flow"].astype(np.int64)
    fb, tb = tab["fl_idx"][:2].astype(np.int64)
    slot_of = np.repeat(np.arange(pj.size), np.diff(fptr))
    if fptr[-1] != flow.size:
        raise ValueError("the pair slots' flow lists do not add up")
    at_k, at_j = pk[slot_of], pj[slot_of]
    ends = ((fb[flow] == at_k) & (tb[flow] == at_j)) | \
        ((tb[flow] == at_k) & (fb[flow] == at_j))
    want = np.where(fb == tb, 1, 2)
    if not ends.all() or np.any(
            np.bincount(flow, minlength=fb.size) != want):
        raise ValueError("every flow row must be listed once at each end")
    if not (np.array_equal(tab["pf_idx"],
                           tab["fl_idx"][:, flow].reshape(6, -1))
            and np.array_equal(tab["pf_y"],
                               tab["fl_y"][:, flow].reshape(4, -1))):
        raise ValueError("a pair_flow entry's descriptor is not its flow "
                         "row's")
    kind = tab["row_kind"]
    c = tab["row_col"].astype(np.int64)
    lin = kind == LINEAR
    if np.any((c[0][lin] < 0) | (c[0][lin] >= n_x) | (c[1][lin] >= n_x)) \
            or np.any((c[0][~lin] < 0) | (c[0][~lin] >= fb.size)):
        raise ValueError("a row descriptor names a column outside the state")
    term_ptr = tab["term_ptr"].astype(np.int64)
    deg, off = tab["term"].astype(np.int64)
    if term_ptr[-1] != deg.size or np.any(deg < 2) or np.any(
            off + deg + 1 > tab["term_co"].size):
        raise ValueError("a cost term's coefficients lie outside term_co")
    check_hess_plan(tab["hess_plan"], n, n_x)
    bus_units, groups = int(tab["hess_plan"][0]), int(tab["hess_plan"][3])
    grp = tab["hess_group"].astype(np.int64)
    k0, k1, s0, s1, q0, q1 = grp if grp.shape == (6, groups) else [None] * 6
    if k0 is None or k0[0] != 0 or k1[-1] != n or \
            np.any(k0[1:] != k1[:-1]) or np.any(k1 <= k0) or \
            np.any(k0 % bus_units) or np.any(s0 != pair_ptr[k0]) or \
            np.any(s1 != pair_ptr[k1]) or np.any(q0 != fptr[s0]) or \
            np.any(q1 != fptr[s1]) or not np.array_equal(
                tab["unit_group"], np.repeat(np.arange(groups),
                                             -(-(k1 - k0) // bus_units))):
        raise ValueError("the Hessian's value groups do not run over the bus "
                         "units in order, each with its buses' slots and "
                         "flow entries")
    at = item_positions(pair_ptr, pj, n, n_x)
    if not np.array_equal(tab["item_at"], at):
        raise ValueError("an item of the Hessian goes elsewhere than its "
                         "slot's or bus's elements")


def opf_fill_table_tensors(tab: dict, spec, device) -> OpfFillTable:
    """``OpfFillTable`` on ``device`` from the numpy fields."""
    fields = {}
    for name, a in tab.items():
        if name == "hess_plan":
            fields[name] = HessPlan(*(int(v) for v in a))
            continue
        dtype = {np.dtype(np.float64): torch.float64,
                 np.dtype(np.int64): torch.int64}.get(a.dtype, torch.int32)
        fields[name] = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=device)
    return OpfFillTable(**fields, n=int(spec.n), g=int(spec.g),
                        n_x=int(spec.n_x), m_e=int(spec.m_e),
                        m_i=int(spec.m_i))


def _check_inputs(arr, x, y, z):
    if x.dim() != 1 or x.shape[0] != arr.n_x:
        raise ValueError(f"x must have shape [{arr.n_x}], got "
                         f"{tuple(x.shape)}")
    where = arr.rows.get_device()
    for name, t, size in (("x", x, arr.n_x), ("y", y, arr.m_e),
                          ("z", z, arr.m_i)):
        if t is None:
            continue
        if t.shape != (size,):
            raise ValueError(f"{name} must have shape [{size}], got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.get_device() != where:
            raise ValueError(f"{name} is on {t.device}, the spec on "
                             f"{arr.rows.device}")
    if (y is None) != (z is None):
        raise ValueError("the Hessian takes both y and z")


def opf_fill(arr, x, y=None, z=None) -> OpfFill:
    """J_E and J_I at the point ``x`` [n_x] of the spec ``arr``
    (``AcOpfArrays``), or, given the raw duals ``y`` [m_E] and ``z``
    [m_I], the Lagrangian Hessian ∇²f - Σ y ∇²c_E - Σ z ∇²c_I."""
    _check_inputs(arr, x, y, z)
    if x.device.type == "cpu":
        return opf_fill_ref(arr, x, y, z)
    if x.device.type != "cuda":
        raise ValueError(f"opf_fill runs on cuda or cpu tensors, not "
                         f"{x.device}")
    return _launch(arr, x, y, z)


opf_fill.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("opf_fill")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.opf_fill_launch.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.opf_fill_launch.restype = i32
    lib.opf_fill_attributes.argtypes = [i32, ptr]
    lib.opf_fill_attributes.restype = i32
    lib.opf_fill_error_string.argtypes = [i32]
    lib.opf_fill_error_string.restype = ctypes.c_char_p
    return lib


class _Tables(ctypes.Structure):
    """``OpfTables`` of csrc/opf_fill.cu."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "row_ptr", "ycol", "yg", "yb", "diag", "gen_ptr", "gen_idx",
        "gen_on", "row_kind", "row_col", "row_val", "fl_idx", "fl_y",
        "pair_ptr", "pair", "pair_fptr", "pair_flow", "pf_idx", "pf_y",
        "hess_group", "unit_group", "item_at", "term_ptr", "term",
        "term_co")]
        + [(name, ctypes.c_int) for name in (
            "n", "g", "n_x", "m_e", "m_i", "nnz", "n_rows", "n_fl", "n_pair",
            "n_term", "n_pf")])


class _Entry:
    """The ``_Tables`` of one spec, the tensors it points into (all but the
    key, so that the entry goes when its key does), and whether a value
    group of the Hessian mode outgrows shared memory (then each launch
    takes a scratch buffer)."""

    __slots__ = ("struct", "address", "held", "spill")

    def __init__(self, arr, tensors, held):
        t = arr.fill
        for name, tt in tensors.items():
            want = torch.float64 if tt.is_floating_point() else \
                torch.int64 if name == "item_at" else torch.int32
            if tt.dtype != want or not tt.is_contiguous():
                raise TypeError(f"{name} must be contiguous {want}")
        self.struct = _Tables(
            **{name: tt.data_ptr() for name, tt in tensors.items()},
            n=t.n, g=t.g, n_x=t.n_x, m_e=t.m_e, m_i=t.m_i,
            nnz=t.ycol.numel(), n_rows=t.row_kind.numel(),
            n_fl=t.fl_y.shape[1], n_pair=t.pair.shape[1],
            n_term=t.term.shape[1], n_pf=t.pair_flow.numel())
        self.address = ctypes.addressof(self.struct)
        self.held = held
        grp = t.hess_group.cpu().numpy().astype(np.int64)
        self.spill = bool(np.any(grp[5] - grp[4] > HESS_FLOW_ROOM)
                          or np.any(grp[3] - grp[2] > HESS_SLOT_ROOM))


#: the ``_Entry`` of each spec, keyed by its ``fill.row_ptr``; rebuilt when
#: the spec's tables or admittances are other tensors
_TABLES = WeakIdKeyDictionary()


def _tables(arr) -> _Entry:
    t = arr.fill
    tensors = {name: getattr(t, name) for name in (
        "row_ptr", "ycol", "diag", "gen_ptr", "gen_idx", "gen_on",
        "row_kind", "row_col", "row_val", "fl_idx", "fl_y", "pair_ptr",
        "pair", "pair_fptr", "pair_flow", "pf_idx", "pf_y", "hess_group",
        "unit_group", "item_at", "term_ptr", "term", "term_co")}
    tensors["yg"], tensors["yb"] = arr.yg, arr.yb
    held = tuple(tt for name, tt in tensors.items() if name != "row_ptr")
    entry = _TABLES.get(t.row_ptr)
    if entry is None or any(a is not b for a, b in zip(entry.held, held)):
        entry = _Entry(arr, tensors, held)
        _TABLES[t.row_ptr] = entry
    return entry


def scratch_doubles(fill: OpfFillTable) -> int:
    """Doubles of the Hessian mode's scratch (csrc/opf_fill.cu)."""
    return (SCRATCH_PER_FLOW * fill.pair_flow.numel()
            + SCRATCH_PER_SLOT * fill.pair.shape[1])


def _launch(arr, x, y=None, z=None, zeroed=False) -> OpfFill:
    """One K6 launch. ``zeroed=True`` hands the kernel an output the caller
    has zeroed (a memset), so that the kernel only writes the values: that
    split is timed against the one-launch fill, and used nowhere else."""
    entry = _tables(arr)
    hess = y is not None
    n_x, m_e, m_i = arr.n_x, arr.m_e, arr.m_i
    rows = n_x if hess else m_e + m_i
    alloc = torch.zeros if zeroed else torch.empty
    out = alloc((rows, n_x), dtype=torch.float64, device=x.device)
    x = x.contiguous()
    scratch = None
    if hess:
        y, z = y.contiguous(), z.contiguous()
        if entry.spill:
            scratch = torch.empty(scratch_doubles(arr.fill),
                                  dtype=torch.float64, device=x.device)
    ctx, stream = _build.launch_context(x.device)
    with ctx:
        err = _library().opf_fill_launch(
            entry.address, x.data_ptr(), y.data_ptr() if hess else None,
            z.data_ptr() if hess and m_i else None,
            out.data_ptr() if out.numel() else None,
            scratch.data_ptr() if scratch is not None else None, int(hess),
            int(not zeroed), *arr.fill.hess_plan, stream)
    if err != 0:
        raise RuntimeError("opf_fill launch failed: "
                           + _library().opf_fill_error_string(err).decode())
    opf_fill.launches += 1
    if hess:
        return OpfFill(None, None, out)
    return OpfFill(out[:m_e], out[m_e:], None)


def kernel_attributes(hessian: bool) -> dict:
    """What the build gave the kernel of one mode (``cudaFuncGetAttributes``
    and its occupancy): registers a thread, local memory a thread in bytes
    (spills and local arrays), static shared memory a block in bytes,
    resident blocks an SM (of 256 threads in the Jacobian mode, 128 in the
    Hessian mode)."""
    vals = (ctypes.c_int * 4)()
    err = _library().opf_fill_attributes(int(hessian), vals)
    if err != 0:
        raise RuntimeError("opf_fill_attributes failed: "
                           + _library().opf_fill_error_string(err).decode())
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), vals))


# ---- the plain version -----------------------------------------------------

def flow_row_value(zv, adm, is_from, cls):
    """One flow row's value from its four variables zv = (θf, θt, Vf, Vt)
    and its end's admittances adm = (gf, bf, gt, bt); mirrors
    ``opf/acopf.flow_values`` (and the JAX package's ``_flow_row_val``)."""
    thf, tht, vf, vt = zv[0], zv[1], zv[2], zv[3]
    vfr, vfi = vf * torch.cos(thf), vf * torch.sin(thf)
    vtr, vti = vt * torch.cos(tht), vt * torch.sin(tht)
    gf, bf, gt, bt = adm[0], adm[1], adm[2], adm[3]
    ire = gf * vfr - bf * vfi + gt * vtr - bt * vti
    iim = gf * vfi + bf * vfr + gt * vti + bt * vtr
    vr = torch.where(is_from, vfr, vtr)
    vi = torch.where(is_from, vfi, vti)
    pp = vr * ire + vi * iim
    qq = vi * ire - vr * iim
    s2 = pp * pp + qq * qq
    i2 = ire * ire + iim * iim
    floor = s2.new_tensor(1e-24)
    sqrt_s = torch.sqrt(torch.maximum(s2, floor))
    sqrt_i = torch.sqrt(torch.maximum(i2, floor))
    return torch.where(cls == 1, pp, torch.where(
        cls == 2, sqrt_s, torch.where(
            cls == 3, s2, torch.where(cls == 4, sqrt_i, i2))))


def _flow_args(arr, x):
    n = arr.n
    fb, tb = arr.fl_fb, arr.fl_tb
    zv = torch.stack([x[fb], x[tb], x[n + fb], x[n + tb]], dim=1)
    return zv, arr.fl_y.T, arr.fl_from, arr.fl_cls


def _first_flow_row(arr):
    """The row of J_I (and of z) of the first flow row."""
    return sum(t.numel() for t in (arr.vlo_i, arr.vhi_i, arr.plo_i,
                                   arr.phi_i, arr.qlo_i, arr.qhi_i, arr.cc_i))


def _jac_eq_ref(arr, x):
    n, g = arr.n, arr.g
    theta, v = x[:n], x[n:2 * n]
    rows, cols = arr.rows, arr.cols
    vi, vj = v[rows], v[cols]
    th = theta[rows] - theta[cols]
    ct, st = torch.cos(th), torch.sin(th)
    gc = arr.yg * ct + arr.yb * st
    gs = arr.yg * st - arr.yb * ct
    t1 = vi * vj * gc
    t2 = vi * vj * gs
    zero = x.new_zeros(n)
    p_bus = zero.index_add(0, rows, t1)
    q_bus = zero.index_add(0, rows, t2)
    diag = rows == cols
    offf = (~diag).to(x.dtype)
    gii = zero.index_add(0, rows, torch.where(diag, arr.yg, 0.0))
    bii = zero.index_add(0, rows, torch.where(diag, arr.yb, 0.0))

    jac = x.new_zeros((arr.m_e, arr.n_x))
    ar = torch.arange(n, device=x.device)

    def add(r, c, val):
        jac.index_put_((r, c), val, accumulate=True)

    # balance rows: d(sup - inj - demand)/d· = -d inj/d·
    add(rows, cols, -t2 * offf)
    add(rows, n + cols, -vi * gc * offf)
    add(ar, ar, q_bus + bii * v * v)
    add(ar, n + ar, -(p_bus / v + gii * v))
    add(n + rows, cols, t1 * offf)
    add(n + rows, n + cols, -vi * gs * offf)
    add(n + ar, ar, -(p_bus - gii * v * v))
    add(n + ar, n + ar, -(q_bus / v - bii * v))
    on = arr.gen_on.to(x.dtype)
    gcols = 2 * n + torch.arange(g, device=x.device)
    add(arr.gen_bus, gcols, on)
    add(n + arr.gen_bus, g + gcols, on)
    r = 2 * n
    jac[r, arr.slack] = 1.0
    r += 1
    for idx, col0 in ((arr.off_idx, 2 * n), (arr.off_idx, 2 * n + g),
                      (arr.fixv_i, n), (arr.fixp_i, 2 * n),
                      (arr.fixq_i, 2 * n + g)):
        k = idx.numel()
        jac[r + torch.arange(k, device=x.device), col0 + idx] = 1.0
        r += k
    return jac


def _jac_ineq_ref(arr, x):
    n, g = arr.n, arr.g
    jac = x.new_zeros((arr.m_i, arr.n_x))
    dev = x.device

    def add(r, c, val):
        jac.index_put_((r, c), torch.as_tensor(val, dtype=x.dtype,
                                               device=dev).expand(r.shape),
                       accumulate=True)

    r = 0
    for idx, col0, sign in ((arr.vlo_i, n, 1.0), (arr.vhi_i, n, -1.0),
                            (arr.plo_i, 2 * n, 1.0),
                            (arr.phi_i, 2 * n, -1.0),
                            (arr.qlo_i, 2 * n + g, 1.0),
                            (arr.qhi_i, 2 * n + g, -1.0)):
        k = idx.numel()
        jac[r + torch.arange(k, device=dev), col0 + idx] = sign
        r += k
    rr = r + torch.arange(arr.cc_i.numel(), device=dev)
    add(rr, 2 * n + arr.cc_i, -arr.cc_aq)
    add(rr, 2 * n + g + arr.cc_i, -arr.cc_ap)
    r += arr.cc_i.numel()
    if arr.fl_fb.numel():
        gz = vmap(grad(flow_row_value))(*_flow_args(arr, x))
        for sel, sign in ((arr.fl_lo_sel, 1.0), (arr.fl_hi_sel, -1.0)):
            rr = r + torch.arange(sel.numel(), device=dev)
            gm = sign * gz[sel]
            fb, tb = arr.fl_fb[sel], arr.fl_tb[sel]
            for a, c in enumerate((fb, tb, n + fb, n + tb)):
                add(rr, c, gm[:, a])
            r += sel.numel()
    k = arr.an_f.numel()
    for sign in (1.0, -1.0):
        rr = r + torch.arange(k, device=dev)
        add(rr, arr.an_f, sign)
        add(rr, arr.an_t, -sign)
        r += k
    h0 = 2 * n + 2 * g
    for gi, hpos, slope, col0, hcol0 in (
            (arr.pwp_gi, arr.pwp_hpos, arr.pwp_slope, 2 * n, h0),
            (arr.pwq_gi, arr.pwq_hpos, arr.pwq_slope, 2 * n + g,
             h0 + arr.n_hp)):
        rr = r + torch.arange(gi.numel(), device=dev)
        add(rr, col0 + gi, -slope)
        add(rr, hcol0 + hpos, 1.0)
        r += gi.numel()
    return jac


def _hess_ref(arr, x, y, z):
    n, g = arr.n, arr.g
    theta, v = x[:n], x[n:2 * n]
    dev = x.device
    hm = x.new_zeros((arr.n_x, arr.n_x))

    def add(r, c, val):
        hm.index_put_((r, c), val, accumulate=True)

    # objective: d² of the polynomial costs, diagonal in Pg/Qg
    for cols, co in arr.poly:
        deg = co.shape[1] - 1
        if deg < 2:
            continue
        pq = x[cols]
        acc = torch.zeros_like(pq)
        for j in range(deg - 1):  # descending coefficients of p''
            k = deg - j
            acc = acc * pq + co[:, j] * k * (k - 1)
        add(cols, cols, acc)

    # balance rows: +y ∇²inj (c_E = sup - inj - pd, so -y∇²c = +y∇²inj)
    rows, cols = arr.rows, arr.cols
    vi, vj = v[rows], v[cols]
    th = theta[rows] - theta[cols]
    ct, st = torch.cos(th), torch.sin(th)
    gc = arr.yg * ct + arr.yb * st
    gs = arr.yg * st - arr.yb * ct
    t1 = vi * vj * gc
    t2 = vi * vj * gs
    diag = rows == cols
    offf = (~diag).to(x.dtype)
    yp = y[:n][rows] * offf
    yq = y[n:2 * n][rows] * offf
    ti, tj = rows, cols
    vic, vjc = n + rows, n + cols
    c_tt = -(yp * t1 + yq * t2)
    add(ti, ti, c_tt)
    add(tj, tj, c_tt)
    add(ti, tj, -c_tt)
    add(tj, ti, -c_tt)
    c_tivi = -yp * vj * gs + yq * vj * gc
    add(ti, vic, c_tivi)
    add(vic, ti, c_tivi)
    c_tivj = -yp * vi * gs + yq * vi * gc
    add(ti, vjc, c_tivj)
    add(vjc, ti, c_tivj)
    c_tjvi = yp * vj * gs - yq * vj * gc
    add(tj, vic, c_tjvi)
    add(vic, tj, c_tjvi)
    c_tjvj = yp * vi * gs - yq * vi * gc
    add(tj, vjc, c_tjvj)
    add(vjc, tj, c_tjvj)
    c_vv = yp * gc + yq * gs
    add(vic, vjc, c_vv)
    add(vjc, vic, c_vv)
    # diagonal Y entries: inj_i has Vi² terms only
    c_dd = (y[:n][rows] * 2.0 * arr.yg
            - y[n:2 * n][rows] * 2.0 * arr.yb) * diag.to(x.dtype)
    add(vic, vic, c_dd)

    # flow rows: z-weighted 4x4 blocks
    if arr.fl_fb.numel():
        r_lo = _first_flow_row(arr)
        r_hi = r_lo + arr.fl_lo_sel.numel()
        wfl = x.new_zeros(arr.fl_fb.numel())
        wfl = wfl.index_add(0, arr.fl_lo_sel,
                            -z[r_lo + torch.arange(arr.fl_lo_sel.numel(),
                                                   device=dev)])
        wfl = wfl.index_add(0, arr.fl_hi_sel,
                            z[r_hi + torch.arange(arr.fl_hi_sel.numel(),
                                                  device=dev)])
        h4 = vmap(hessian(flow_row_value))(*_flow_args(arr, x))
        fb, tb = arr.fl_fb, arr.fl_tb
        i4 = (fb, tb, n + fb, n + tb)
        for a in range(4):
            for b in range(4):
                add(i4[a], i4[b], wfl * h4[:, a, b])
    return hm


def opf_fill_ref(arr, x, y=None, z=None) -> OpfFill:
    """Plain PyTorch K6: the JAX package's ``jac_eq``, ``jac_ineq`` and
    ``hess`` as scatter-adds into zeroed matrices, the flow rows' partials
    from ``torch.func``. The CPU path, and the check K6 is held to on the
    card."""
    if y is None:
        return OpfFill(_jac_eq_ref(arr, x), _jac_ineq_ref(arr, x), None)
    return OpfFill(None, None, _hess_ref(arr, x, y, z))
