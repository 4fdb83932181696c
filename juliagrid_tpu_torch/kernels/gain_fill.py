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
H. The CUDA source, its two mappings (the fleet regime at ``FLEET_MIN``
scenarios and more, a lane a scenario; the small-B regime, lanes over a G
row's nonzeros) and what bounds it are described in ``csrc/gain_fill.cu``.

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
as entries and tables. For the fleet regime alone the G rows are cut into
bands of about 512 elements a scenario (``band_rows``), and each band lists
the duplicated entries its contributions read, so that those are summed
once for 32 scenarios (``band_lists``): built at a table's first fleet
launch (``fleet_bands``), so that a single estimate never pays for them.

The values come in one of two layouts (``value_strides``): row-major ``[B,
E]``, or scenario-minor, the transpose of a contiguous ``[E, B]`` buffer,
which K3's entry mode writes at ``FLEET_MIN`` scenarios and more
(``scenario_minor``), so that one value of 32 scenarios is one 256-byte
load. Any other strides are refused; a layout is never copied.

``gain_fill`` dispatches on the device of its tensors: a CUDA tensor goes to
the kernel (the call raises if it does not build or launch), a CPU tensor
to ``gain_fill_ref``, the plain PyTorch version — gathers, products, the
fixed-order ``ops/segments.py::segment_sum`` in the table's order and a
scatter into a zeroed G — which gives the kernel's bits.
``gain_fill.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.segments import segment_sum
from ..utils.profiling import default_timings
from . import _build
from ._build import I64, INT, PTR

#: the batch from which K8 runs its fleet regime (a lane a scenario) and
#: K3's entry mode writes the values scenario-minor: where the two ways (K3
#: and K8 together) tie at case118, 0.0534 against 0.0526 ms at 32
#: scenarios, the small-B way 12-30% faster at 16-24 and the fleet way 30%
#: faster at 64; at 1,369 buses the fleet way wins from 8 (no main path
#: sends 2-31 scenarios). scripts/k8_crossover.py on an H100 80GB HBM3 at
#: 700 W.
FLEET_MIN = 32
#: G elements a band holds for one scenario, about (``band_rows``): small
#: bands put more blocks on an SM, so that some store while others sum
#: (512 against 1,024 and 2,048: 0.279 against 0.346 ms at case118 x1024,
#: scripts/k8_timeline.py --band-elements on an H100)
BAND_ELEMENTS = 512
#: the most shared memory a band's block should take (bytes): a band of
#: dense rows is halved until it fits, so that blocks share an SM
BAND_SHARED = 64 * 1024
#: shared memory a thread block of this card can use (bytes)
SHARED_LIMIT = 232448


def scenario_minor(batch: int) -> bool:
    """Whether ``batch`` scenarios' entry values are stored scenario-minor
    (and K8 runs its fleet regime)."""
    return batch >= FLEET_MIN


def band_rows(n: int) -> int:
    """G rows a band, at most: about ``BAND_ELEMENTS`` elements of G a
    scenario (``gain_fill_table`` halves it for dense rows)."""
    return max(1, BAND_ELEMENTS // n)


def _band_shared(dups: int, nonzeros: int) -> int:
    """Bytes of shared memory a fleet block takes for a band of ``dups``
    duplicated entries and ``nonzeros`` nonzeros (32 scenarios; rhs's
    staging if larger): ``fleet_shared`` in the source."""
    return 8 * max(32 * int(dups) + 33 * int(nonzeros), 8 * 33)


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


class Bands(NamedTuple):
    """The fleet regime's band lists of a ``GainHost`` (numpy, int64)."""

    f_a: np.ndarray       # [C] the reference of c_a, a duplicate as
    f_b: np.ndarray       # [C]  -(slot + 1), its slot in its band's list
    bdup_ptr: np.ndarray  # [bands + 1] each band's duplicated entries
    bdup: np.ndarray      # their d, ascending
    band: int             # G rows a band


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
    host: GainHost        # what the fleet regime's band lists come from


class DeviceBands(NamedTuple):
    """``Bands`` on the device (int32), with the sizes of its bands."""

    f_a: torch.Tensor
    f_b: torch.Tensor
    bdup_ptr: torch.Tensor
    bdup: torch.Tensor
    band: int             # G rows a band
    band_dups: int        # the most duplicated entries of a band
    band_nz: int          # the most nonzeros of a band


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


def band_lists(host: GainHost) -> Bands:
    """The fleet regime's bands of ``host``: consecutive G rows, about
    ``BAND_ELEMENTS`` elements a scenario, halved until a band's shared
    memory fits ``BAND_SHARED``; each band's duplicated entries (ascending
    d), and the contributions' references with a duplicate as its slot in
    its band's list."""
    n = host.n
    row = host.u_col[host.c_a]   # a contribution's G row: a's column
    refs = host.u_ref[host.c_a], host.u_ref[host.c_b]
    dups = [np.flatnonzero(ref < 0) for ref in refs]
    ndup = max(len(host.dup_ptr) - 1, 1)
    band = band_rows(n)
    while True:
        nbands = -(-n // band)
        key = np.concatenate([row[d] // band * ndup - ref[d] - 1
                              for ref, d in zip(refs, dups)])
        keys, slot = np.unique(key, return_inverse=True)
        bdup_ptr = np.searchsorted(keys // ndup, np.arange(nbands + 1))
        band_nz = np.diff(host.nz_ptr[np.minimum(np.arange(nbands + 1) * band,
                                                 n)])
        if band == 1 or _band_shared(np.diff(bdup_ptr).max(initial=0),
                                     band_nz.max(initial=0)) <= BAND_SHARED:
            break
        band //= 2
    slot = slot.reshape(-1) - bdup_ptr[key // ndup]
    f_a, f_b = refs
    f_a[dups[0]] = -(slot[:len(dups[0])] + 1)
    f_b[dups[1]] = -(slot[len(dups[0]):] + 1)
    return Bands(f_a=f_a, f_b=f_b, bdup_ptr=bdup_ptr, bdup=keys % ndup,
                 band=int(band))


def check_bands(host: GainHost, bands: Bands) -> None:
    """Raise unless ``bands`` reads every contribution's entries as
    ``host`` does: a raw position as in c_a/c_b, a duplicate through its
    band's list, which ascends (``host`` checked by ``check_gain_table``)."""
    if len(bands.bdup_ptr) != -(-host.n // bands.band) + 1 or np.any(
            np.diff(bands.bdup_ptr) < 0):
        raise ValueError("bdup_ptr is not a pointer over the bands")
    row = host.u_col[host.c_a]
    for f, c in ((bands.f_a, host.c_a), (bands.f_b, host.c_b)):
        ref = host.u_ref[c]
        dup = np.flatnonzero(ref < 0)
        band = row[dup] // bands.band
        slot = -f[dup] - 1
        lo = bands.bdup_ptr[band]
        if (np.any((f != ref) & (ref >= 0)) or np.any(slot < 0)
                or np.any(lo + slot >= bands.bdup_ptr[band + 1])
                or np.any(bands.bdup[lo + slot] != -ref[dup] - 1)):
            raise ValueError("a band's duplicate list misses a reference")


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
        pairs=int(np.count_nonzero(host.pair_of >= 0)) // 2, host=host)


def device_table(host: GainHost, device) -> GainTable:
    """The checked tables of ``host`` on ``device``."""
    check_gain_table(host)
    return _device(host, torch.device(device))


#: the tables of each pattern (and the band lists of each table), keyed by
#: one tensor of it, with the other objects they were built from (compared
#: on use: a tensor by identity)
_CACHE = WeakIdKeyDictionary()


def cached_table(key: torch.Tensor, held: tuple, build):
    """The table ``build()`` gives for the pattern of ``key`` and
    ``held``, built once for as long as ``key`` lives and the same
    ``held`` come with it. The entry holds ``held`` but not ``key``, so
    that it goes when ``key`` does. A build is the span ``tables.build``
    of ``utils.profiling.default_timings``."""
    entry = _CACHE.get(key)
    if entry is None or len(entry[1]) != len(held) or any(
            (a is not b) if isinstance(a, torch.Tensor) else a != b
            for a, b in zip(entry[1], held)):
        with default_timings.span("tables.build"):
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


def value_strides(vals) -> tuple[int, int]:
    """``(se, sb)``: value ``ref`` of scenario ``b`` lies at ``ref * se + b
    * sb`` of ``vals``' data. Row-major ``[B, E]`` gives ``(1, E)``,
    scenario-minor (the transpose of a contiguous ``[E, B]``) ``(B, 1)``;
    any other strides raise."""
    batch, entries = vals.shape
    if vals.is_contiguous():
        return 1, entries
    if vals.mT.is_contiguous():
        return batch, 1
    raise ValueError(f"vals must be row-major [B, E] or scenario-minor (the "
                     f"transpose of a contiguous [E, B]), not strides "
                     f"{tuple(vals.stride())}")


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
    return value_strides(vals)


def gain_fill(table: GainTable, vals, w, pair_off, r):
    """``(G [B, N, N], rhs [B, N])`` of the raw entry values ``vals [B,
    E]`` (the pattern's order, masked; row-major or scenario-minor),
    weights ``w [m]`` and ``pair_off [p]`` and residuals ``r [B, m]``."""
    strides = _check_inputs(table, vals, w, pair_off, r)
    if vals.device.type == "cpu":
        return gain_fill_ref(table, vals, w, pair_off, r)
    if vals.device.type != "cuda":
        raise ValueError(f"gain_fill runs on cuda or cpu tensors, not "
                         f"{vals.device}")
    return _launch(table, vals, strides, w, pair_off, r)


gain_fill.launches = 0


def gain_fill_ref(table: GainTable, vals, w, pair_off, r):
    """Plain PyTorch K8: the duplicates summed, each contribution's ``w *
    (a * b)``, their fixed-order sum per nonzero (plus 1 at the slack's),
    a scatter into a zeroed G, and rhs as each column's fixed-order sum of
    ``a * (W r + P r)[row]``. The CPU path, and the check K8 is held to on
    the card. It takes either layout of ``vals``."""
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


LIBRARY = _build.Library(
    "gain_fill", gain_fill_launch=(INT, [PTR] * 2 + [I64] * 2 + [PTR] * 5
                                   + [INT] * 2 + [PTR]))

#: the tensors of ``GainTables`` in csrc/gain_fill.cu, in order: the
#: table's, then its bands' (null outside the fleet regime)
_FIELDS = ("nz_ptr", "nz_col", "c_ptr", "c_a", "c_b", "c_w", "dup_ptr",
           "dup_raw", "col_ptr", "col_ref", "col_row", "pair_of", "partner")
_BAND_FIELDS = ("f_a", "f_b", "bdup_ptr", "bdup")
#: its ints, in order: the table's, then its bands'
_INTS = ("n", "m", "entries", "slack", "slack_nz")
_BAND_INTS = ("band", "band_dups", "band_nz")
_DTYPES = dict.fromkeys(_FIELDS + _BAND_FIELDS, torch.int32)
#: ``GainTables`` of each table (keyed by its ``nz_ptr``): without the band
#: lists, and for the fleet regime with them
_Tables = _build.Struct("GainTables", _DTYPES, _INTS + _BAND_INTS)
_FleetTables = _build.Struct("GainTables", _DTYPES, _INTS + _BAND_INTS)


def fleet_bands(table: GainTable) -> DeviceBands:
    """The checked band lists of ``table`` on its device, built from its
    host tables at the first call (``cached_table``), for as long as the
    table lives."""
    def build():
        host = table.host
        lists = band_lists(host)
        check_bands(host, lists)
        band = lists.band
        band_nz = np.diff(host.nz_ptr[np.minimum(
            np.arange(0, host.n + band, band), host.n)])
        return DeviceBands(
            **{name: torch.as_tensor(getattr(lists, name).astype(np.int32),
                                     device=table.nz_ptr.device)
               for name in _BAND_FIELDS},
            band=band, band_dups=int(np.diff(lists.bdup_ptr).max(initial=0)),
            band_nz=int(band_nz.max(initial=0)))

    return cached_table(table.nz_ptr, (), build)


def _tables(table: GainTable, bands: DeviceBands | None) -> _build.Entry:
    """The ``GainTables`` of ``table``, with its band lists ``bands`` in the
    fleet regime."""
    tensors = {name: getattr(table, name) for name in _FIELDS}
    ints = {name: getattr(table, name) for name in _INTS}
    if bands is None:
        return _Tables.get("nz_ptr", tensors, **ints)
    tensors.update((name, getattr(bands, name)) for name in _BAND_FIELDS)
    ints.update((name, getattr(bands, name)) for name in _BAND_INTS)
    return _FleetTables.get("nz_ptr", tensors, **ints)


def fleet_shared(table: GainTable) -> int:
    """Bytes of shared memory a block of the fleet regime takes."""
    bands = fleet_bands(table)
    return _band_shared(bands.band_dups, bands.band_nz)


def _launch(table: GainTable, vals, strides, w, pair_off, r):
    batch = vals.shape[0]
    n = table.n
    fleet = scenario_minor(batch)
    if fleet and fleet_shared(table) > SHARED_LIMIT:
        raise ValueError(f"a band of this table needs {fleet_shared(table)} "
                         f"bytes of shared memory, above {SHARED_LIMIT}")
    bands = fleet_bands(table) if fleet else None
    w, r = w.contiguous(), r.contiguous()
    pair_off = pair_off.contiguous()
    gain = torch.empty((batch, n, n), dtype=torch.float64, device=vals.device)
    rhs = torch.empty((batch, n), dtype=torch.float64, device=vals.device)
    LIBRARY.launch(
        "gain_fill_launch", vals.device, _tables(table, bands).address,
        vals.data_ptr(), *strides, w.data_ptr(),
        pair_off.data_ptr() if pair_off.numel() else None, r.data_ptr(),
        gain.data_ptr(), rhs.data_ptr(), batch, int(fleet))
    gain_fill.launches += 1
    return gain, rhs
