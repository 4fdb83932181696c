"""K8 ``gain_fill``: the WLS estimators' normal equations from H's fixed
entry pattern.

One launch forms, for B >= 1 scenarios of one measurement pattern, the
gain ``G = Hᵀ W H + Hᵀ P H + e_s e_sᵀ`` ``[B, N, N]`` and the right-hand
side ``rhs = Hᵀ (W + P) r`` ``[B, N]`` from H's entry values ``[B, E]``
(W the diagonal weights, P the correlated pairs' off-diagonals, e_s the
slack column or none). It replaces the port's dense f64 GEMM over an H that
is more than 99% zeros with what ``juliagrid_tpu/estimation/acse.py::
gn_increment`` (:597) is built around: H as its entry list, masked in entry
space (:642) and applied as O(nnz) segment sums (:645-650), never a dense
H. The CUDA source, its mapping and what bounds it are described in
``csrc/gain_fill.cu``.

``gain_fill_table`` builds the tables once on the host from the pattern
(each entry's row and column), the correlated pairs, the slack and the
order N: the pattern's duplicate (row, column) entries coalesced in
ascending raw position (an AC injection row meets its own bus twice, as a
Y-bus entry and as the diagonal pair), G's structural nonzeros with each
one's contributions in a host-fixed order, and each column's entries for
rhs. Row status, weights and values only multiply, so status and variance
edits and every scenario of a fleet reuse a table (``cached_table``, held
for as long as the pattern's tensors live); a measurement added or removed
builds a new one. ``dense_entries`` gives the linear estimators' dense H
as entries and tables.

``gain_fill`` dispatches on the device of its tensors: a CUDA tensor goes to
the kernel (the call raises if it does not build or launch), a CPU tensor
to ``gain_fill_ref``, the plain PyTorch version — gathers, products, the
fixed-order ``ops/segments.py::segment_sum`` in the table's order and a
scatter into a zeroed G — which gives the kernel's bits.
``gain_fill.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.segments import segment_sum
from . import _build


class GainHost(NamedTuple):
    """K8's tables on the host (numpy, int64), with what the checks and the
    plain version read besides the kernel's tables."""

    nz_ptr: np.ndarray    # [N + 1] G row i's structural nonzeros
    nz_col: np.ndarray    # [Z] their columns, ascending within a row
    c_ptr: np.ndarray     # [Z + 1] each nonzero's contributions
    c_a: np.ndarray       # [C] coalesced entry a of each contribution
    c_b: np.ndarray       # [C] coalesced entry b
    c_w: np.ndarray       # [C] weight: r < m is w[r], m + p is pair_off[p]
    u_row: np.ndarray     # [U] row of each coalesced entry (ascending
    u_col: np.ndarray     # [U] column               (row, column))
    u_ref: np.ndarray     # [U] a raw position, or -(d + 1): duplicate d
    dup_ptr: np.ndarray   # [D + 1] raw positions of each duplicated entry,
    dup_raw: np.ndarray   # ascending
    col_ptr: np.ndarray   # [N + 1] column i's coalesced entries, ascending
    col_u: np.ndarray     # row
    pair_of: np.ndarray   # [m] the pair of a row, or -1
    partner: np.ndarray   # [m] the other row of that pair, or -1
    n: int                # N, the order of G
    m: int                # rows
    entries: int          # E, raw entries a scenario
    slack: int            # the slack column, or -1


class GainTable(NamedTuple):
    """K8's tables on the device: the kernel's (int32) and the plain
    version's segment ids (int64)."""

    nz_ptr: torch.Tensor
    nz_col: torch.Tensor
    c_ptr: torch.Tensor
    c_a: torch.Tensor     # entry references (``GainHost.u_ref``)
    c_b: torch.Tensor
    c_w: torch.Tensor
    dup_ptr: torch.Tensor
    dup_raw: torch.Tensor
    col_ptr: torch.Tensor
    col_ref: torch.Tensor
    col_row: torch.Tensor
    pair_of: torch.Tensor
    partner: torch.Tensor
    c_nz: torch.Tensor    # i64[C] the nonzero of each contribution
    nz_flat: torch.Tensor  # i64[Z] i N + j of each nonzero
    dup_of: torch.Tensor  # i64[..] the duplicate of each dup_raw position
    col_of: torch.Tensor  # i64[..] the column of each col_ref entry
    paired: torch.Tensor  # i64[..] rows in a pair
    slack_nz: int         # the nonzero (slack, slack), or -1
    n: int
    m: int
    entries: int
    slack: int
    pairs: int


def _ranges(starts, lens):
    """``(owner, index)``: for each range ``[starts[k], starts[k] +
    lens[k])`` in turn, its owner k and each index in it."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    owner = np.repeat(np.arange(len(lens)), lens)
    first = np.cumsum(lens) - lens
    return owner, starts[owner] + np.arange(int(lens.sum())) - first[owner]


def gain_fill_table(ent_rows, ent_cols, m: int, n: int, pair_r1=(),
                    pair_r2=(), slack: int = -1) -> GainHost:
    """K8's tables for an H of ``m`` rows and ``n`` columns whose raw
    entries lie at ``(ent_rows[k], ent_cols[k])``, with the correlated row
    pairs ``pair_r1[p]``, ``pair_r2[p]`` and the slack column (-1: none;
    its entries are left out, as the slack mask zeroes them, and G gets 1
    on its diagonal). Raises unless every entry lies inside H and every
    row is in at most one pair with another row."""
    rows = np.asarray(ent_rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(ent_cols, dtype=np.int64).reshape(-1)
    r1 = np.asarray(pair_r1, dtype=np.int64).reshape(-1)
    r2 = np.asarray(pair_r2, dtype=np.int64).reshape(-1)
    if len(rows) != len(cols):
        raise ValueError("ent_rows and ent_cols differ in length")
    if n < 1 or m < 1:
        raise ValueError(f"empty H: m={m}, n={n}")
    if len(rows) and (rows.min() < 0 or rows.max() >= m or cols.min() < 0
                      or cols.max() >= n):
        raise ValueError(f"an entry lies outside the {m} x {n} H")
    if not -1 <= slack < n:
        raise ValueError(f"slack {slack} outside [-1, {n})")
    pair_of = np.full(m, -1, dtype=np.int64)
    partner = np.full(m, -1, dtype=np.int64)
    both = np.concatenate([r1, r2])
    if len(r1) != len(r2) or np.any(r1 == r2) or (
            len(both) and (both.min() < 0 or both.max() >= m
                           or len(np.unique(both)) != len(both))):
        raise ValueError("every row must be in at most one pair, with "
                         "another row")
    pair_of[r1] = pair_of[r2] = np.arange(len(r1))
    partner[r1], partner[r2] = r2, r1

    # coalesced entries, sorted by (row, column); the slack column's left out
    pos = np.flatnonzero(cols != slack)
    key, inverse, counts = np.unique(rows[pos] * n + cols[pos],
                                     return_inverse=True, return_counts=True)
    u_row, u_col = key // n, key % n
    grouped = pos[np.argsort(inverse.reshape(-1), kind="stable")]
    u_first = np.cumsum(counts) - counts
    dup = np.flatnonzero(counts > 1)
    u_ref = grouped[u_first].copy()
    u_ref[dup] = -(np.arange(len(dup)) + 1)
    dup_ptr = np.concatenate([[0], np.cumsum(counts[dup])])
    dup_raw = grouped[_ranges(u_first[dup], counts[dup])[1]]

    # contributions: every pair of one row's entries (weight w[r]), and for
    # each correlated pair every entry of one row with every entry of the
    # other, both ways (weight pair_off[p])
    row_lo = np.searchsorted(u_row, np.arange(m + 1))
    per_row = np.diff(row_lo)
    ca, cb = _ranges(row_lo[u_row], per_row[u_row])
    parts = [(ca, cb, u_row[ca])]
    for ra, rb in ((r1, r2), (r2, r1)):
        pa, ua = _ranges(row_lo[ra], per_row[ra])
        owner, ub = _ranges(row_lo[rb[pa]], per_row[rb[pa]])
        parts.append((ua[owner], ub, m + pa[owner]))
    # the pair terms by their smaller entry first, so that the order of a
    # nonzero's contributions is the same for G[i, j] and G[j, i]: the
    # diagonal terms by row (one a row), then the pair terms by pair and
    # smaller entry (a pair's two terms at (i, j) are its two at (j, i))
    pair = [np.concatenate(x) for x in zip(*parts[1:])]
    first = np.argsort(np.minimum(pair[0], pair[1]), kind="stable")
    ca, cb, cw = (np.concatenate([d, q[first]])
                  for d, q in zip(parts[0], pair))
    ckey = u_col[ca] * n + u_col[cb]
    if n * n * (m + len(r1)) < 2 ** 62:   # one stable sort of one key
        order = np.argsort(ckey * (m + len(r1)) + cw, kind="stable")
    else:
        order = np.lexsort((cw, ckey))
    ca, cb, cw, ckey = ca[order], cb[order], cw[order], ckey[order]
    nz = ckey[np.r_[True, ckey[1:] != ckey[:-1]]] if len(ckey) else ckey
    if slack >= 0:
        nz = np.union1d(nz, [slack * n + slack])
    c_ptr = np.searchsorted(ckey, nz, side="left")
    c_ptr = np.concatenate([c_ptr, [len(ckey)]])
    nz_row, nz_col = nz // n, nz % n
    nz_ptr = np.searchsorted(nz_row, np.arange(n + 1))

    col_u = np.argsort(u_col, kind="stable")   # by column, then row
    col_ptr = np.searchsorted(u_col[col_u], np.arange(n + 1))
    host = GainHost(
        nz_ptr=nz_ptr, nz_col=nz_col, c_ptr=c_ptr, c_a=ca, c_b=cb, c_w=cw,
        u_row=u_row, u_col=u_col, u_ref=u_ref, dup_ptr=dup_ptr,
        dup_raw=dup_raw, col_ptr=col_ptr, col_u=col_u, pair_of=pair_of,
        partner=partner, n=int(n), m=int(m), entries=len(rows),
        slack=int(slack))
    if max(len(ca), len(rows), len(nz)) >= 2 ** 31:
        raise ValueError("K8's tables index with int32")
    return host


def check_gain_table(host: GainHost) -> None:
    """Raise unless the tables give every element of G and of rhs one
    writer: G's nonzeros in ascending columns within each row (each one
    sums its own contributions), every contribution on its nonzero's row
    and column, and every coalesced entry in one column list."""
    n = host.n
    ptr = host.nz_ptr
    if ptr[0] != 0 or ptr[-1] != len(host.nz_col) or np.any(np.diff(ptr) < 0):
        raise ValueError("nz_ptr is not a CSR row pointer")
    row = np.repeat(np.arange(n), np.diff(ptr))
    key = row * n + host.nz_col
    if np.any(np.diff(key) <= 0):
        raise ValueError("a G row's nonzeros do not ascend")
    owner = np.repeat(np.arange(len(key)), np.diff(host.c_ptr))
    if (np.any(host.u_col[host.c_a] != row[owner])
            or np.any(host.u_col[host.c_b] != host.nz_col[owner])):
        raise ValueError("a contribution lies off its nonzero")
    if not np.array_equal(np.sort(host.col_u), np.arange(len(host.u_row))):
        raise ValueError("rhs's column lists do not hold every entry once")


def _device(host: GainHost, device) -> GainTable:
    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    c_nz = np.repeat(np.arange(len(host.nz_col)), np.diff(host.c_ptr))
    nz_row = np.repeat(np.arange(host.n), np.diff(host.nz_ptr))
    nz_flat = nz_row * host.n + host.nz_col
    slack_nz = -1
    if host.slack >= 0:
        slack_nz = int(np.flatnonzero(nz_flat == host.slack * (host.n + 1))[0])
    return GainTable(
        nz_ptr=i32(host.nz_ptr), nz_col=i32(host.nz_col),
        c_ptr=i32(host.c_ptr), c_a=i32(host.u_ref[host.c_a]),
        c_b=i32(host.u_ref[host.c_b]), c_w=i32(host.c_w),
        dup_ptr=i32(host.dup_ptr), dup_raw=i32(host.dup_raw),
        col_ptr=i32(host.col_ptr), col_ref=i32(host.u_ref[host.col_u]),
        col_row=i32(host.u_row[host.col_u]), pair_of=i32(host.pair_of),
        partner=i32(host.partner), c_nz=i64(c_nz), nz_flat=i64(nz_flat),
        dup_of=i64(np.repeat(np.arange(len(host.dup_ptr) - 1),
                             np.diff(host.dup_ptr))),
        col_of=i64(np.repeat(np.arange(host.n), np.diff(host.col_ptr))),
        paired=i64(np.flatnonzero(host.pair_of >= 0)), slack_nz=slack_nz,
        n=host.n, m=host.m, entries=host.entries, slack=host.slack,
        pairs=int(np.count_nonzero(host.pair_of >= 0)) // 2)


def device_table(host: GainHost, device) -> GainTable:
    """The checked tables of ``host`` on ``device``."""
    check_gain_table(host)
    return _device(host, torch.device(device))


#: the tables of each pattern, keyed by one tensor of it, with the other
#: objects they were built from (compared on use: a tensor by identity)
_CACHE = WeakIdKeyDictionary()


def cached_table(key: torch.Tensor, held: tuple, build) -> GainTable:
    """The table ``build()`` gives for the pattern of ``key`` and
    ``held``, built once for as long as ``key`` lives and the same
    ``held`` come with it. The entry holds ``held`` but not ``key``, so
    that it goes when ``key`` does."""
    entry = _CACHE.get(key)
    if entry is None or len(entry[1]) != len(held) or any(
            (a is not b) if isinstance(a, torch.Tensor) else a != b
            for a, b in zip(entry[1], held)):
        entry = (build(), held)
        _CACHE[key] = entry
    return entry[0]


def dense_entries(h: torch.Tensor, slack: int = -1, pair_r1=None,
                  pair_r2=None):
    """``(vals [1, E], tables)`` of a dense H ``[m, N]`` (the linear
    estimators'): its nonzero entries in row-major order, read from H on
    its device, and the tables of their pattern with the slack column and
    the correlated pairs; built once for as long as ``h`` lives (an edit of
    a linear estimator's set builds a new H)."""
    def build():
        rows, cols = h.nonzero(as_tuple=True)
        host = gain_fill_table(
            rows.cpu().numpy(), cols.cpu().numpy(), h.shape[0], h.shape[1],
            *((() if p is None else p.cpu().numpy())
              for p in (pair_r1, pair_r2)), slack)
        return h[rows, cols][None].contiguous(), device_table(host, h.device)

    return cached_table(h, (slack, pair_r1), build)


def _check_inputs(table: GainTable, vals, w, off, r):
    batch = vals.shape[0]
    for name, t, shape in (("vals", vals, (batch, table.entries)),
                           ("w", w, (table.m,)), ("r", r, (batch, table.m)),
                           ("pair_off", off, (table.pairs,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != table.nz_ptr.device:
            raise ValueError(f"{name} is on {t.device}, the table on "
                             f"{table.nz_ptr.device}")
    if batch < 1:
        raise ValueError("empty batch")


def gain_fill(table: GainTable, vals, w, pair_off, r):
    """``(G [B, N, N], rhs [B, N])`` of the raw entry values ``vals [B,
    E]`` (the pattern's order, masked), weights ``w [m]`` and ``pair_off
    [p]`` and residuals ``r [B, m]``."""
    _check_inputs(table, vals, w, pair_off, r)
    if vals.device.type == "cpu":
        return gain_fill_ref(table, vals, w, pair_off, r)
    if vals.device.type != "cuda":
        raise ValueError(f"gain_fill runs on cuda or cpu tensors, not "
                         f"{vals.device}")
    return _launch(table, vals, w, pair_off, r)


gain_fill.launches = 0


def gain_fill_ref(table: GainTable, vals, w, pair_off, r):
    """Plain PyTorch K8: the duplicates summed, each contribution's ``w *
    (a * b)``, their fixed-order sum per nonzero (plus 1 at the slack's),
    a scatter into a zeroed G, and rhs as each column's fixed-order sum of
    ``a * (W r + P r)[row]``. The CPU path, and the check K8 is held to on
    the card."""
    batch = vals.shape[0]
    n = table.n
    ndup = table.dup_ptr.shape[0] - 1
    dup = segment_sum(vals[:, table.dup_raw.long()], table.dup_of, ndup,
                      forward_ad=False)
    ext = torch.cat([vals, dup], -1)

    def ref(idx):
        idx = idx.long()
        return ext[:, torch.where(idx >= 0, idx, table.entries - 1 - idx)]

    wt = torch.cat([w, pair_off])[table.c_w.long()]
    contrib = wt * (ref(table.c_a) * ref(table.c_b))
    nnz = table.nz_col.shape[0]
    val = segment_sum(contrib, table.c_nz, nnz, forward_ad=False)
    if table.slack_nz >= 0:
        val[:, table.slack_nz] = val[:, table.slack_nz] + 1.0
    gain = vals.new_zeros(batch, n * n)
    gain[:, table.nz_flat] = val
    wr = w * r
    if table.paired.numel():
        rows = table.paired
        wr[:, rows] = wr[:, rows] + pair_off[table.pair_of[rows].long()] \
            * r[:, table.partner[rows].long()]
    rhs = segment_sum(ref(table.col_ref) * wr[:, table.col_row.long()],
                      table.col_of, n, forward_ad=False)
    return gain.view(batch, n, n), rhs


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("gain_fill")
    ptr = ctypes.c_void_p
    lib.gain_fill_launch.argtypes = [ptr] * 7 + [ctypes.c_int, ptr]
    lib.gain_fill_launch.restype = ctypes.c_int
    lib.gain_fill_error_string.argtypes = [ctypes.c_int]
    lib.gain_fill_error_string.restype = ctypes.c_char_p
    return lib


#: the tensors of ``GainTables`` in csrc/gain_fill.cu, in order
_FIELDS = ("nz_ptr", "nz_col", "c_ptr", "c_a", "c_b", "c_w", "dup_ptr",
           "dup_raw", "col_ptr", "col_ref", "col_row", "pair_of", "partner")


class _Tables(ctypes.Structure):
    """``GainTables`` of csrc/gain_fill.cu."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _FIELDS]
                + [(name, ctypes.c_int) for name in (
                    "n", "m", "entries", "slack")])


#: the ``_Tables`` of each table (keyed by its ``nz_ptr``)
_STRUCTS = WeakIdKeyDictionary()


def _struct(table: GainTable) -> int:
    held = _STRUCTS.get(table.nz_ptr)
    if held is None:
        for name in _FIELDS:
            t = getattr(table, name)
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise TypeError(f"{name} must be contiguous int32")
        held = _Tables(**{name: getattr(table, name).data_ptr()
                          for name in _FIELDS},
                       n=table.n, m=table.m, entries=table.entries,
                       slack=table.slack)
        _STRUCTS[table.nz_ptr] = held
    return ctypes.addressof(held)


def _launch(table: GainTable, vals, w, pair_off, r):
    batch = vals.shape[0]
    n = table.n
    vals, w, r = vals.contiguous(), w.contiguous(), r.contiguous()
    pair_off = pair_off.contiguous()
    gain = torch.empty((batch, n, n), dtype=torch.float64, device=vals.device)
    rhs = torch.empty((batch, n), dtype=torch.float64, device=vals.device)
    ctx, stream = _build.launch_context(vals.device)
    with ctx:
        err = _library().gain_fill_launch(
            _struct(table), vals.data_ptr(), w.data_ptr(),
            pair_off.data_ptr() if pair_off.numel() else None, r.data_ptr(),
            gain.data_ptr(), rhs.data_ptr(), batch, stream)
    if err != 0:
        raise RuntimeError("gain_fill launch failed: "
                           + _library().gain_fill_error_string(err).decode())
    gain_fill.launches += 1
    return gain, rhs
