"""K7 ``kkt_fill``: the AC OPF's structured KKT, filled into its BBD blocks.

One call computes, at one iterate of the interior point, what
``juliagrid_tpu/opf/kkt_bbd.py`` computes in ``AcKktBbd._values`` (:335)
and ``_assemble`` (:504): the KKT's COO values (1.34M at 10,000 buses) in
the emission order of ``_group_seq_static``, their Jacobi equilibration
``d = 1/sqrt(max(rowmax |val|, 1e-12))`` (a max over single contributions,
not over summed entries), and the equilibrated values summed into the
padded blocks ``a_ii [k, ni, ni]``, ``a_ib [k, ni, mbl]``, ``a_bi [k, mbl,
ni]`` and ``a_bb [mb, mb]``, with 1.0 on the padded interior diagonal. The
CUDA source, its mapping and what bounds it are described in
``csrc/kkt_fill.cu``.

The kernel reads two sets of tables. The spec's (``AcOpfArrays``: the Y-bus
values, K6's flow-row, generator and cost tables, the cut coefficients),
which a numeric live edit rebuilds; and the KKT's structure (``KktTable``),
which ``kkt_fill_table`` builds once on the host from an ``opf/kkt_bbd.
AcKktBbd`` layout: the COO rows and columns, the group bases, and for each
distinct element of the padded blocks the COO entries that land there in
ascending order. ``check_route`` holds the structure to the rule that gives
every COO value and every block element one writer.

``kkt_fill`` dispatches on the device of ``x``: a CUDA tensor goes to the
kernel (the call raises if it does not build or launch), a CPU tensor to
``kkt_fill_ref``, the plain PyTorch transcription of the JAX package's
``_values`` and ``_assemble`` (flow rows through ``torch.func`` of
``opf_fill.flow_row_value``, the scatter through ``index_put_``).
``kkt_fill.launches`` counts kernel launches, two a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, hessian, vmap
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.segments import segment_sum
from . import _build
from .opf_fill import _flow_args, flow_row_value

#: the COO group bases K7 reads, in the order of ``KktTables.base`` in
#: csrc/kkt_fill.cu (a name a layout lacks has base -1)
BASES = ("stencil", "flow_h", "bound", "cc", "flow_lo", "flow_hi", "angle",
         "pwp", "pwq", "delta", "je_p_theta", "je_p_v", "je_p_theta_d",
         "je_p_v_d", "je_q_theta", "je_q_v", "je_q_theta_d", "je_q_v_d",
         "je_pg", "je_qg", "eq_diag")
#: the counts and first rows K7 reads, in the order of ``KktTables.size``
SIZES = ("n", "g", "n_x", "m_e", "m_i", "nnz", "n_fl", "n_aug", "n_entries",
         "n_dest", "n_pad", "n_cost", "n_bound", "n_cc", "n_an", "n_pwp",
         "n_pwq", "n_lo", "n_hi", "n_unit", "cc_row", "flo_row", "fhi_row",
         "an_lo_row", "an_hi_row", "pwp_row", "pwq_row")


class KktTable(NamedTuple):
    """K7's structure tables of one ``AcKktBbd`` layout."""

    rows: torch.Tensor      # i32[E] COO row of each entry
    cols: torch.Tensor      # i32[E] COO column
    erow: torch.Tensor      # i32[E] its row, -1 for a cross-interior zero
    eflat: torch.Tensor     # i64[E] its element in the flat block buffer
    yrow: torch.Tensor      # i32[nnz] the row bus of each Y-bus entry
    gbus: torch.Tensor      # i32[g] each generator's bus
    unit_pos: torch.Tensor  # i32[2, U] the unit rows of J_E, and transposes
    dest_off: torch.Tensor  # i64[D] each destination element ...
    dest_ptr: torch.Tensor  # i32[D + 1] ... and its entries
    dest_ent: torch.Tensor  # i32[E] ascending within a destination
    pad_off: torch.Tensor   # i64[P] the padded interior diagonal
    base: tuple             # COO bases of BASES
    size: dict              # SIZES, and the layout's k, ni, mb, mbl, n_w
    unit_groups: tuple      # lengths of J_E's unit-row groups, in order


class KktFill(NamedTuple):
    vals: torch.Tensor   # f64[E] the COO values (cross-interior zeros 0)
    d: torch.Tensor      # f64[n_aug] the equilibration
    a_ii: torch.Tensor   # f64[k, ni, ni] equilibrated blocks (views of one
    a_ib: torch.Tensor   # f64[k, ni, mbl]                       buffer)
    a_bi: torch.Tensor   # f64[k, mbl, ni]
    a_bb: torch.Tensor   # f64[mb, mb]


def _block_sizes(k, ni, mb, mbl):
    return (k * ni * ni, k * ni * mbl, k * mbl * ni, mb * mb)


def kkt_fill_table(lay) -> dict:
    """Numpy fields of ``KktTable`` from an ``AcKktBbd`` layout ``lay``."""
    spec = lay.spec
    n, g = int(spec.n), int(spec.g)
    rows, cols = lay.rows, lay.cols
    e_count = rows.size
    if e_count >= 2**31:
        raise ValueError(f"{e_count} COO entries do not fit K7's int32 "
                         "tables")
    k, ni, mb, mbl = lay.k, lay.ni, lay.mb, lay.mbl
    o_ii, o_ib, o_bi, o_bb = np.cumsum((0,) + _block_sizes(k, ni, mb,
                                                           mbl)[:3])
    eflat = np.zeros(e_count, dtype=np.int64)
    s, blk, r_, c_ = lay.ii
    eflat[s] = o_ii + (blk * ni + r_) * ni + c_
    s, blk, r_, c_ = lay.ib
    eflat[s] = o_ib + (blk * ni + r_) * mbl + c_
    s, blk, r_, c_ = lay.bi
    eflat[s] = o_bi + (blk * mbl + r_) * ni + c_
    s, r_, c_ = lay.bb
    eflat[s] = o_bb + r_ * mb + c_
    erow = rows.copy()
    erow[lay.cross] = -1
    order = np.argsort(eflat, kind="stable")
    dest_off, first = np.unique(eflat[order], return_index=True)
    pad_b, pad_s = lay.pad
    size = {
        "n": n, "g": g, "n_x": int(spec.n_x), "m_e": int(spec.m_e),
        "m_i": int(spec.m_i), "nnz": int(np.asarray(spec.rows).size),
        "n_fl": len(spec.fl_k), "n_aug": lay.n_aug, "n_entries": e_count,
        "n_dest": dest_off.size, "n_pad": pad_b.size,
        "n_cost": lay.bases.get("stencil", 0),
        "n_bound": spec.ji_rows["bound"][1], "n_cc": len(spec.cc_i),
        "n_an": len(spec.an_f), "n_pwp": len(spec.pwp[0]),
        "n_pwq": len(spec.pwq[0]), "n_lo": spec.ji_rows["fl_lo"][1],
        "n_hi": spec.ji_rows["fl_hi"][1], "n_unit": int(spec.m_e) - 2 * n,
        "k": k, "ni": ni, "mb": mb, "mbl": mbl, "n_w": lay.n_w}
    for name, group in (("cc_row", "cc"), ("flo_row", "fl_lo"),
                        ("fhi_row", "fl_hi"), ("an_lo_row", "an_lo"),
                        ("an_hi_row", "an_hi"), ("pwp_row", "pwp"),
                        ("pwq_row", "pwq")):
        start, count = spec.ji_rows[group]
        size[name] = start if count else 0
    k_off = len(spec.gen_off)
    unit_groups = tuple(int(c) for c in (
        1, k_off, k_off, len(spec.fixv_i), len(spec.fixp_i),
        len(spec.fixq_i)) if c)
    return dict(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        erow=erow.astype(np.int32), eflat=eflat,
        yrow=np.asarray(spec.rows, dtype=np.int32),
        gbus=np.asarray(spec.gen_bus, dtype=np.int32),
        unit_pos=lay.unit_pos.astype(np.int32), dest_off=dest_off,
        dest_ptr=np.append(first, e_count).astype(np.int32),
        dest_ent=order.astype(np.int32),
        pad_off=(o_ii + (pad_b * ni + pad_s) * ni + pad_s).astype(np.int64),
        base=tuple(int(lay.bases.get(name, -1)) for name in BASES),
        size=size, unit_groups=unit_groups)


def launch_positions(tab: dict) -> np.ndarray:
    """Every COO position the kernel's value launch writes, item by item
    in the kernel's order (``csrc/kkt_fill.cu::values_kernel``)."""
    s = tab["size"]
    b = dict(zip(BASES, tab["base"]))
    nnz, nf, n, g = s["nnz"], s["n_fl"], s["n"], s["g"]
    out = [np.arange(s["n_cost"])]
    e = np.arange(nnz)
    out += [b["stencil"] + t * nnz + e for t in range(15)]
    for name in ("je_p_theta", "je_p_v", "je_q_theta", "je_q_v"):
        out += [b[name] + e, b[name] + nnz + e]
    if nf:
        f = np.arange(nf)
        out += [b["flow_h"] + t * nf + f for t in range(16)]
    for name, count in (("flow_lo", s["n_lo"]), ("flow_hi", s["n_hi"])):
        if count:
            out += [b[name] + t * count + np.arange(count)
                    for t in range(16)]
    if s["n_bound"]:
        out.append(b["bound"] + np.arange(s["n_bound"]))
    for name, count in (("cc", s["n_cc"]), ("angle", s["n_an"]),
                        ("pwp", s["n_pwp"]), ("pwq", s["n_pwq"])):
        if count:
            out += [b[name] + t * count + np.arange(count) for t in range(4)]
    out.append(b["delta"] + np.arange(s["n_x"]))
    k = np.arange(n)
    for name in ("je_p_theta_d", "je_p_v_d", "je_q_theta_d", "je_q_v_d"):
        out += [b[name] + k, b[name] + n + k]
    i = np.arange(g)
    for name in ("je_pg", "je_qg"):
        out += [b[name] + i, b[name] + g + i]
    out += [tab["unit_pos"][0], tab["unit_pos"][1]]
    out.append(b["eq_diag"] + np.arange(s["m_e"]))
    return np.concatenate([np.asarray(o, dtype=np.int64) for o in out])


def check_route(tab: dict, lay) -> None:
    """Raise unless the tables give every COO value and every block
    element one writer: the value launch's items write every COO position
    once; every COO entry sits in one destination's list, the lists are
    ascending, each entry's element is its destination's, no element is a
    destination twice, and the padded diagonal is no destination."""
    s = tab["size"]
    e_count = s["n_entries"]
    written = launch_positions(tab)
    if written.size != e_count or not np.array_equal(
            np.sort(written), np.arange(e_count)):
        raise ValueError("the value launch does not write every COO "
                         "position once")
    ptr = tab["dest_ptr"].astype(np.int64)
    ent = tab["dest_ent"].astype(np.int64)
    off = tab["dest_off"]
    if ptr[0] != 0 or ptr[-1] != e_count or np.any(np.diff(ptr) < 1) or \
            not np.array_equal(np.sort(ent), np.arange(e_count)):
        raise ValueError("every COO entry must sit in one destination's "
                         "list")
    dest_of = np.repeat(np.arange(off.size), np.diff(ptr))
    if np.any(tab["eflat"][ent] != off[dest_of]):
        raise ValueError("a destination lists an entry of another element")
    same = dest_of[1:] == dest_of[:-1]
    if np.any(ent[1:][same] <= ent[:-1][same]):
        raise ValueError("a destination's entries are not ascending")
    total = sum(_block_sizes(lay.k, lay.ni, lay.mb, lay.mbl))
    pads = tab["pad_off"]
    if np.unique(off).size != off.size or np.unique(pads).size != \
            pads.size or np.intersect1d(off, pads).size or \
            np.any((off < 0) | (off >= total)) or \
            np.any((pads < 0) | (pads >= total)):
        raise ValueError("a block element has two writers or lies outside "
                         "the blocks")


def kkt_fill_table_tensors(tab: dict, lay, device) -> KktTable:
    """``KktTable`` on ``device`` from the numpy fields."""
    fields = {}
    for name, a in tab.items():
        if isinstance(a, np.ndarray):
            a = torch.as_tensor(np.ascontiguousarray(a), device=device)
        fields[name] = a
    size = dict(tab["size"])
    return KktTable(**{**fields, "size": size})


def _check_inputs(tab: KktTable, arr, x, y, z, sigma, ge, gi):
    s = tab.size
    for name, t, want in (("x", x, s["n_x"]), ("y", y, s["m_e"]),
                          ("z", z, s["m_i"]), ("sigma", sigma, s["m_i"]),
                          ("ge", ge, s["m_e"]), ("gi", gi, s["m_i"])):
        if t is None:
            continue
        if tuple(t.shape) != (want,):
            raise ValueError(f"{name} must have shape [{want}], got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != tab.rows.device:
            raise ValueError(f"{name} is on {t.device}, the tables on "
                             f"{tab.rows.device}")
    f = arr.fill
    if (f.ycol.numel(), f.fl_y.shape[1], f.gen_on.numel(),
            arr.cc_aq.numel(), arr.pwp_slope.numel(),
            arr.pwq_slope.numel(), f.term.shape[1]) != (
            s["nnz"], s["n_fl"], s["g"], s["n_cc"], s["n_pwp"], s["n_pwq"],
            s["n_cost"]):
        raise ValueError("the spec's arrays do not have the structure the "
                         "KKT tables were built for")


def kkt_fill(tab: KktTable, arr, x, y, z, sigma, delta: float, sf: float,
             ge=None, gi=None) -> KktFill:
    """The KKT of the AC OPF spec ``arr`` (``AcOpfArrays``) at ``x`` with
    the scaled duals ``y``/``z``, Σ = ``sigma``, regularization ``delta``,
    objective scale ``sf`` and row scales ``ge``/``gi`` (None: 1), in the
    layout of ``tab``."""
    _check_inputs(tab, arr, x, y, z, sigma, ge, gi)
    if x.device.type == "cpu":
        return kkt_fill_ref(tab, arr, x, y, z, sigma, delta, sf, ge, gi)
    if x.device.type != "cuda":
        raise ValueError(f"kkt_fill runs on cuda or cpu tensors, not "
                         f"{x.device}")
    return _launch(tab, arr, x, y, z, sigma, delta, sf, ge, gi)


kkt_fill.launches = 0


def _blocks(tab: KktTable, flat) -> tuple:
    s = tab.size
    k, ni, mb, mbl = s["k"], s["ni"], s["mb"], s["mbl"]
    parts = torch.split(flat, _block_sizes(k, ni, mb, mbl))
    return (parts[0].view(k, ni, ni), parts[1].view(k, ni, mbl),
            parts[2].view(k, mbl, ni), parts[3].view(mb, mb))


def _ones_if_none(t, size, like):
    return like.new_ones(size) if t is None else t


# ---- the kernel ------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("kkt_fill")
    ptr = ctypes.c_void_p
    lib.kkt_fill_launch.argtypes = ([ptr] * 7 + [ctypes.c_double] * 2
                                    + [ptr] * 4)
    lib.kkt_fill_launch.restype = ctypes.c_int
    lib.kkt_fill_error_string.argtypes = [ctypes.c_int]
    lib.kkt_fill_error_string.restype = ctypes.c_char_p
    return lib


#: the tensors of ``KktTables`` in csrc/kkt_fill.cu, in order: from the
#: spec's arrays (``arr.`` and ``arr.fill.``), then from ``KktTable``
_ARR = ("yg", "yb", "cc_aq", "cc_ap", "pwp_slope", "pwq_slope")
_FILL = ("row_ptr", "ycol", "diag", "gen_on", "fl_idx", "fl_y", "term_ptr",
         "term", "term_co")
_TAB = ("rows", "cols", "erow", "yrow", "gbus", "unit_pos", "dest_off",
        "dest_ptr", "dest_ent", "pad_off")


class _Tables(ctypes.Structure):
    """``KktTables`` of csrc/kkt_fill.cu."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _ARR + _FILL + _TAB]
                + [("base", ctypes.c_int * len(BASES)),
                   ("size", ctypes.c_int * len(SIZES))])


#: each table's ``_Tables`` (keyed by the table's ``rows``) with the other
#: tensors it points into (not the key, so that an entry goes when its key
#: does); rebuilt when the spec's tensors change
_TABLES = WeakIdKeyDictionary()


def _tables(tab: KktTable, arr) -> int:
    tensors = [getattr(arr, name) for name in _ARR]
    tensors += [getattr(arr.fill, name) for name in _FILL]
    tensors += [getattr(tab, name) for name in _TAB]
    held = tuple(t for t in tensors if t is not tab.rows)
    entry = _TABLES.get(tab.rows)
    if entry is None or any(a is not b for a, b in zip(entry[1], held)):
        for name, t in zip(_ARR + _FILL + _TAB, tensors):
            want = (torch.float64 if t.is_floating_point() else
                    torch.int64 if name in ("dest_off", "pad_off")
                    else torch.int32)
            if t.dtype != want or not t.is_contiguous():
                raise TypeError(f"{name} must be contiguous {want}")
        struct = _Tables(
            *[t.data_ptr() if t.numel() else None for t in tensors],
            (ctypes.c_int * len(BASES))(*tab.base),
            (ctypes.c_int * len(SIZES))(*[tab.size[s] for s in SIZES]))
        entry = (struct, held)
        _TABLES[tab.rows] = entry
    return ctypes.addressof(entry[0])


def _launch(tab: KktTable, arr, x, y, z, sigma, delta, sf, ge, gi,
            ) -> KktFill:
    """The two K7 launches of one call, after the memsets of the row
    maxima and the block buffer."""
    s = tab.size
    dev = x.device
    ge = _ones_if_none(ge, s["m_e"], x)
    gi = _ones_if_none(gi, s["m_i"], x)
    x, y, z, sigma, ge, gi = (t.contiguous() for t in (x, y, z, sigma, ge,
                                                        gi))
    tables = _tables(tab, arr)
    vals = torch.empty(s["n_entries"], dtype=torch.float64, device=dev)
    rmax = torch.zeros(s["n_aug"], dtype=torch.float64, device=dev)
    d = torch.empty(s["n_aug"], dtype=torch.float64, device=dev)
    flat = torch.zeros(sum(_block_sizes(s["k"], s["ni"], s["mb"], s["mbl"])),
                       dtype=torch.float64, device=dev)
    lib = _library()
    ctx, stream = _build.launch_context(dev)

    def ptr(t):
        return t.data_ptr() if t.numel() else None

    with ctx:
        err = lib.kkt_fill_launch(
            tables, x.data_ptr(), ptr(y), ptr(z), ptr(sigma), ptr(ge),
            ptr(gi), float(sf), float(delta), vals.data_ptr(),
            rmax.data_ptr(), d.data_ptr(), flat.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("kkt_fill launch failed: "
                           + lib.kkt_fill_error_string(err).decode())
    kkt_fill.launches += 2
    return KktFill(vals, d, *_blocks(tab, flat))


# ---- the plain version -----------------------------------------------------

def _y_terms(arr, x, n):
    """Each Y-bus entry's closed forms at ``x``: V_i, V_j, G cos + B sin,
    G sin - B cos, the products V_i V_j (G cos + B sin) and V_i V_j (G sin
    - B cos), and whether it is a diagonal entry."""
    theta, v = x[:n], x[n:2 * n]
    rows, cols = arr.rows, arr.cols
    vi, vj = v[rows], v[cols]
    th = theta[rows] - theta[cols]
    ct, st = torch.cos(th), torch.sin(th)
    gc = arr.yg * ct + arr.yb * st
    gs = arr.yg * st - arr.yb * ct
    return vi, vj, gc, gs, vi * vj * gc, vi * vj * gs, rows == cols


def je_groups(arr, x, n, terms=None) -> list:
    """The raw J_E values of the balance rows at ``x`` as (rows, values),
    one pair for each of the eight groups ``je_p_theta`` .. ``je_q_v_d``
    of the KKT's emission order (``terms``: ``_y_terms`` at ``x``). The
    plain version's J_E and ``AcKktBbd.row_maxes`` both read them."""
    vi, vj, gc, gs, t1, t2, diag = terms or _y_terms(arr, x, n)
    v = x[n:2 * n]
    rows = arr.rows
    offf = (~diag).to(x.dtype)
    # the bus sums in a fixed order (one input, one trajectory on the card)
    p_bus = segment_sum(t1, rows, n)
    q_bus = segment_sum(t2, rows, n)
    gii = segment_sum(torch.where(diag, arr.yg, 0.0), rows, n)
    bii = segment_sum(torch.where(diag, arr.yb, 0.0), rows, n)
    ar = torch.arange(n, device=x.device)
    return [(rows, -t2 * offf), (rows, -vi * gc * offf),
            (ar, q_bus + bii * v * v), (ar, -(p_bus / v + gii * v)),
            (n + rows, t1 * offf), (n + rows, -vi * gs * offf),
            (n + ar, -(p_bus - gii * v * v)),
            (n + ar, -(q_bus / v - bii * v))]


def kkt_values_ref(tab: KktTable, arr, x, y, z, sigma, delta, sf, ge=None,
                   gi=None):
    """The KKT's COO values: the JAX package's ``AcKktBbd._values``, group
    by group in its emission order."""
    s = tab.size
    n, g, nx, m_e, m_i = s["n"], s["g"], s["n_x"], s["m_e"], s["m_i"]
    dev = x.device
    ge = _ones_if_none(ge, m_e, x)
    gi = _ones_if_none(gi, m_i, x)
    y_raw = ge * y / sf
    z_raw = gi * z / sf if m_i else x.new_zeros(0)
    sig_eff = sigma * gi * gi if m_i else x.new_zeros(0)

    def ji_rows(start, count):
        return start + torch.arange(count, device=dev)

    vals = []

    # --- W: polynomial cost diagonals
    for cols, co in arr.poly:
        deg = co.shape[1] - 1
        if deg < 2:
            continue
        pq = x[cols]
        acc = torch.zeros_like(pq)
        for j in range(deg - 1):
            kk = deg - j
            acc = acc * pq + co[:, j] * kk * (kk - 1)
        vals.append(sf * acc)

    # --- W: balance Hessian stencils
    rows = arr.rows
    terms = _y_terms(arr, x, n)
    vi, vj, gc, gs, t1, t2, diag = terms
    offf = (~diag).to(x.dtype)
    yp = y_raw[:n][rows] * offf
    yq = y_raw[n:2 * n][rows] * offf
    c_tt = -(yp * t1 + yq * t2)
    c_tivi = -yp * vj * gs + yq * vj * gc
    c_tivj = -yp * vi * gs + yq * vi * gc
    c_tjvi = yp * vj * gs - yq * vj * gc
    c_tjvj = yp * vi * gs - yq * vi * gc
    c_vv = yp * gc + yq * gs
    c_dd = (y_raw[:n][rows] * 2.0 * arr.yg
            - y_raw[n:2 * n][rows] * 2.0 * arr.yb) * diag.to(x.dtype)
    for cvals in (c_tt, c_tt, -c_tt, -c_tt, c_tivi, c_tivi, c_tivj, c_tivj,
                  c_tjvi, c_tjvi, c_tjvj, c_tjvj, c_vv, c_vv, c_dd):
        vals.append(sf * cvals)

    # --- W: flow-row Hessians
    lo_rows = ji_rows(s["flo_row"], s["n_lo"])
    hi_rows = ji_rows(s["fhi_row"], s["n_hi"])
    nf = s["n_fl"]
    if nf:
        wfl = x.new_zeros(nf)
        wfl = wfl.index_add(0, arr.fl_lo_sel, -z_raw[lo_rows])
        wfl = wfl.index_add(0, arr.fl_hi_sel, z_raw[hi_rows])
        h4 = vmap(hessian(flow_row_value))(*_flow_args(arr, x))
        for a in range(4):
            for b in range(4):
                vals.append(sf * wfl * h4[:, a, b])

    # --- W: J_Iᵀ Σ J_I
    if s["n_bound"]:
        vals.append(sig_eff[:s["n_bound"]])
    if s["n_cc"]:
        sc = sig_eff[ji_rows(s["cc_row"], s["n_cc"])]
        aq, ap = arr.cc_aq, arr.cc_ap
        vals += [sc * aq * aq, sc * aq * ap, sc * ap * aq, sc * ap * ap]
    if nf:
        gz = vmap(grad(flow_row_value))(*_flow_args(arr, x))
        for sel, rows_j in ((arr.fl_lo_sel, lo_rows),
                            (arr.fl_hi_sel, hi_rows)):
            if not sel.numel():
                continue
            gm = gz[sel]
            sr = sig_eff[rows_j]
            for a in range(4):
                for b in range(4):
                    vals.append(sr * gm[:, a] * gm[:, b])
    if s["n_an"]:
        s_lo = sig_eff[ji_rows(s["an_lo_row"], s["n_an"])] \
            + sig_eff[ji_rows(s["an_hi_row"], s["n_an"])]
        vals += [s_lo, -s_lo, -s_lo, s_lo]
    for start, count, slope in ((s["pwp_row"], s["n_pwp"], arr.pwp_slope),
                                (s["pwq_row"], s["n_pwq"], arr.pwq_slope)):
        if count:
            sr = sig_eff[ji_rows(start, count)]
            vals += [sr * slope * slope, -sr * slope, -sr * slope, sr]

    # --- W: delta diagonal
    vals.append(x.new_full((nx,), delta))

    # --- J_E values (each emitted twice: block and transpose)
    def both(row_idx, val):
        val = ge[row_idx] * val
        vals.extend((val, val))

    for row_idx, val in je_groups(arr, x, n, terms):
        both(row_idx, val)
    on = arr.gen_on.to(x.dtype)
    both(arr.gen_bus, on)
    both(n + arr.gen_bus, on)
    r = 2 * n
    for count in tab.unit_groups:
        both(ji_rows(r, count), x.new_ones(count))
        r += count

    # --- equality diagonal regularization
    vals.append(x.new_full((m_e,), -1e-10))
    return torch.cat(vals)


def kkt_fill_ref(tab: KktTable, arr, x, y, z, sigma, delta, sf, ge=None,
                 gi=None) -> KktFill:
    """Plain PyTorch K7: the JAX package's ``_values`` and ``_assemble``
    (cross-interior entries forced to 0.0, the row maxima, the
    equilibration, one scatter-add of every equilibrated entry into the
    block buffer, 1.0 on the padded diagonal). The CPU path, and the check
    K7 is held to on the card."""
    s = tab.size
    vals = kkt_values_ref(tab, arr, x, y, z, sigma, delta, sf, ge, gi)
    vals = torch.where(tab.erow >= 0, vals, 0.0)
    rows, cols = tab.rows.long(), tab.cols.long()
    rmax = x.new_zeros(s["n_aug"]).scatter_reduce(0, rows, vals.abs(),
                                                  "amax")
    d = 1.0 / torch.sqrt(rmax.clamp(min=1e-12))
    vals_s = vals * d[rows] * d[cols]
    flat = x.new_zeros(sum(_block_sizes(s["k"], s["ni"], s["mb"], s["mbl"])))
    flat.index_put_((tab.eflat,), vals_s, accumulate=True)
    flat.index_put_((tab.pad_off,), x.new_ones(tab.pad_off.numel()),
                    accumulate=True)
    return KktFill(vals, d, *_blocks(tab, flat))
