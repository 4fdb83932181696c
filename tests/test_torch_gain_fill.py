"""K8 ``gain_fill`` and K3's entry mode: their plain PyTorch versions
against the JAX package on the CPU.

The same measurement sets (case14test, case30test, case118 with every row
type, correlated PMU pairs and inactive rows), compiled by the JAX package
and carried across, go through the JAX package's pieces and the port's:

- K8's tables give every element of G and of rhs one writer and coalesce
  the pattern's duplicate entries; numpy walks of ``csrc/gain_fill.cu``'s
  two mappings (the small-B regime's spans of chunks, the fleet regime's
  bands of rows for 32 scenarios) at batches on both sides of
  ``FLEET_MIN``, at even and odd N, write every element once and give the
  plain version's bits; a band's duplicate sums, taken once, give the
  bits of the sums at each reference;
- the plain versions in the scenario-minor layout (K3's entry mode stores
  its values so from ``FLEET_MIN`` scenarios on) give the row-major bits,
  and K8 refuses any other strides;
- the gain and right-hand side of ``gain_fill_ref`` against the f64 formula
  ``Hmᵀ·WH + diag(reg)`` from ``build_h`` and ``_weighted`` (the pair terms
  inside W) and ``Hᵀ W r`` by ``jax.ops.segment_sum`` over ``h_entries``,
  to 1e-13 of max|G| (and of max|rhs|), also after a variance edit;
- K3's entry mode (``se_fill_entries_ref``) against ``gn_increment``'s
  masked ``vals`` (1e-12, the same arithmetic in another summation order),
  and its host-built positions walked as the kernel writes them;
- ``gn_increment``, ``state_estimation`` and an 8-scenario
  ``batched_se_solve`` against the JAX package: equal iteration counts,
  increments within 1e-9 and states within 1e-9 (the JAX package's f32
  gain refined in f64 against the port's f64 gain, as in
  ``tests/test_torch_se.py``);
- the DC and PMU estimators' gains against the JAX package's dense
  formulas (1e-13 of max|G|) and their solves against ``_dcse_solve`` and
  ``_pmuse_solve`` (1e-9);
- the plain version twice the same bits; the table reused after a value
  edit and built anew after a measurement is added.

The CUDA kernels themselves are held to the plain versions on the card by
``chip_smoke.py`` (phase 5b)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.estimation import acse as jax_acse
from juliagrid_tpu.estimation import dcse as jax_dcse
from juliagrid_tpu.estimation import pmuse as jax_pmuse
from juliagrid_tpu.parallel.batch import batched_se_solve_jit
from juliagrid_tpu.powerflow import ac as jax_ac
from juliagrid_tpu_torch.convert import (ac_arrays_from_numpy,
                                         dcse_arrays_from_numpy,
                                         pmuse_arrays_from_numpy,
                                         se_arrays_from_numpy)
from juliagrid_tpu_torch.estimation import acse as torch_acse
from juliagrid_tpu_torch.estimation import dcse as torch_dcse
from juliagrid_tpu_torch.estimation import pmuse as torch_pmuse
from juliagrid_tpu_torch.kernels import _build
from juliagrid_tpu_torch.kernels import gain_fill as k8
from juliagrid_tpu_torch.kernels import se_fill as k3
from juliagrid_tpu_torch.parallel import batched_se_solve

GAIN_TOL = 1e-13       # of max|G| (max|rhs|): one f64 formula, two orders
SPAN = 8               # chunks a small-B warp streams (kSpan, gain_fill.cu)
RHS_COLS = 8           # rhs columns a fleet block (kWarps, gain_fill.cu)
ENTRY_TOL = dict(rtol=1e-12, atol=1e-12)
STATE_TOL = dict(rtol=0, atol=1e-9)
CASES = ("case14test", "case30test", "case118")


def every_row_type(pkg, system, pf):
    """All 21 row types, correlated PMU pairs and inactive rows, through
    ``pkg``'s public API from the solved power flow ``pf``."""
    mon = pkg.measurement(system)
    pkg.add_voltmeter(mon, analysis=pf)
    pkg.add_ammeter(mon, analysis=pf)
    pkg.add_ammeter(mon, analysis=pf, square=True)
    pkg.add_wattmeter(mon, analysis=pf)
    pkg.add_varmeter(mon, analysis=pf)
    pkg.add_pmu(mon, analysis=pf, polar=True)
    pkg.add_pmu(mon, analysis=pf, polar=True, square=True, status_bus=-1)
    pkg.add_pmu(mon, analysis=pf)
    pkg.add_pmu(mon, analysis=pf, correlated=True, status_from=-1)
    pkg.update_voltmeter(mon, mon.voltmeter.label.label(3), status=0)
    pkg.update_wattmeter(mon, mon.wattmeter.label.label(5), status=0)
    return mon


@pytest.fixture(scope="module", params=CASES)
def carried(request, data_path):
    """A case with every row type, compiled by the JAX package and carried
    into the port, with its K8 tables."""
    system = jg.power_system(str(data_path / f"{request.param}.m"))
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True, current=True)
    mon = every_row_type(jg, system, pf)
    jarr, _, _, host = jax_acse.compile_se_arrays(system, mon,
                                                  return_host=True)
    jnet = jax_ac.compile_ac_arrays(system)
    tarr = se_arrays_from_numpy(host, "cpu")
    tnet = ac_arrays_from_numpy(
        **{f: np.asarray(getattr(jnet, f)) for f in jnet._fields},
        device="cpu")
    n = system.bus.number
    rows, cols = jax_acse.h_entry_pattern(host, jnet, n, xp=np)
    gain_host = k8.gain_fill_table(rows, cols, len(host.mean), 2 * n,
                                   host.pair_r1, host.pair_r2,
                                   int(host.slack))
    return dict(case=request.param, jarr=jarr, jnet=jnet, tarr=tarr,
                tnet=tnet, host=host, gain_host=gain_host, rows=rows,
                cols=cols, n=n, vm=np.asarray(pf.voltage.magnitude),
                va=np.asarray(pf.voltage.angle))


def _state(c, seed, batch=1):
    rng = np.random.default_rng(seed)
    vm = c["vm"] + 0.02 * rng.standard_normal((batch, c["n"]))
    va = c["va"] + 0.05 * rng.standard_normal((batch, c["n"]))
    return vm, va


def _port_gain(c, vm, va, arr=None):
    """The port's gain and right-hand side at the states ``vm``/``va``
    (``[B, n]``): K3's entry mode and K8, each on its plain version."""
    arr = c["tarr"] if arr is None else arr
    return torch_acse._gain_equations(arr, c["tnet"], torch.tensor(vm),
                                      torch.tensor(va),
                                      arr.mean.expand(len(vm), -1))


def _jax_gain(c, vm, va, jarr=None):
    """The f64 gain ``Hmᵀ·WH + diag(reg)`` and ``Hᵀ W r`` from the JAX
    package's own pieces at the state ``vm``/``va`` (``[n]``)."""
    jarr = c["jarr"] if jarr is None else jarr
    n = c["n"]
    vm, va = jnp.asarray(vm), jnp.asarray(va)
    H, h = jax_acse.build_h(jarr, c["jnet"], vm, va)
    col_mask = jnp.ones(2 * n).at[jarr.slack].set(0.0)
    Hm = H * col_mask[None, :]
    r = jarr.mean - h
    WH, wr = jax_acse._weighted(jarr, Hm, r)
    gain = Hm.T @ WH + jnp.diag(1.0 - col_mask)
    vals, _ = jax_acse.h_entries(jarr, c["jnet"], vm, va)
    rows, cols = jnp.asarray(c["rows"]), jnp.asarray(c["cols"])
    vals = vals * jarr.status[rows] * col_mask[cols]
    rhs = jax.ops.segment_sum(vals * wr[rows], cols, num_segments=2 * n)
    return np.asarray(gain), np.asarray(rhs)


def _assert_gain(got, want):
    for g, w in zip(got, want):
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(g - w).max() <= GAIN_TOL * scale


# --------------------------------------------------------------------------
# The tables: one writer per element, duplicates coalesced
# --------------------------------------------------------------------------

def _entries(host, v, ref):
    """The value of entry reference ``ref`` for every scenario of ``v [B,
    E]``: a raw position, or a duplicate summed from 0.0 in ascending raw
    position (``entry()`` of csrc/gain_fill.cu)."""
    if ref >= 0:
        return v[:, ref]
    s = np.zeros(len(v))
    d = -ref - 1
    for q in range(host.dup_ptr[d], host.dup_ptr[d + 1]):
        s = s + v[:, host.dup_raw[q]]
    return s


def _wr(host, w, off, r):
    """``(W r + P r)`` ``[B, m]`` as the kernel forms it."""
    wr = w * r
    rows = np.flatnonzero(host.pair_of >= 0)
    partner = r[:, host.partner[rows]]
    wr[:, rows] = wr[:, rows] + off[host.pair_of[rows]] * partner
    return wr


def _rhs_column(host, v, wr, c):
    s = np.zeros(len(v))
    for q in range(host.col_ptr[c], host.col_ptr[c + 1]):
        u = host.col_u[q]
        s = s + _entries(host, v, host.u_ref[u]) * wr[:, host.u_row[u]]
    return s


def _slack_nz(host):
    if host.slack < 0:
        return -1
    i = host.slack
    return host.nz_ptr[i] + int(np.flatnonzero(
        host.nz_col[host.nz_ptr[i]:host.nz_ptr[i + 1]] == i)[0])


def _walk_small(host, v, w, off, r):
    """csrc/gain_fill.cu's small-B regime in numpy (the scenarios side by
    side): a warp per (scenario, column) of rhs forms the column's terms 32
    at a time and lane 0 adds them in order; a warp per (scenario, G row,
    span of SPAN chunks of 32 VEC columns) finds its first nonzero by
    binary search, stores a chunk without nonzeros as zeros, and otherwise
    forms the chunk's products w * (a * b) 32 at a time, the lane of each
    nonzero adding its own from 0.0 in the table's order into the chunk.
    Returns G, rhs and how often each element of each was written."""
    batch, n = len(v), host.n
    vec = 2 if n % 2 == 0 else 1
    chunk = 32 * vec
    spans = -(-(-(-n // chunk)) // SPAN)
    weight = np.concatenate([w, off])
    refa, refb = host.u_ref[host.c_a], host.u_ref[host.c_b]
    slack_nz = _slack_nz(host)
    g = np.full((batch, n, n), np.nan)
    writes = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        lo, end = host.nz_ptr[i], host.nz_ptr[i + 1]
        for sp in range(spans):
            first = sp * SPAN * chunk
            p = lo + int(np.searchsorted(host.nz_col[lo:end], first))
            for c0 in range(first, min(n, first + SPAN * chunk), chunk):
                q = p
                while q < end and host.nz_col[q] < c0 + chunk:
                    q += 1
                buf = np.zeros((batch, chunk))
                e0, e1 = host.c_ptr[p], host.c_ptr[q]
                prod = [weight[host.c_w[e]] * (_entries(host, v, refa[e])
                                               * _entries(host, v, refb[e]))
                        for e in range(e0, e1)]   # 32 at a time
                for k in range(p, q):             # a lane per nonzero
                    s = np.zeros(batch)
                    for e in range(host.c_ptr[k], host.c_ptr[k + 1]):
                        s = s + prod[e - e0]
                    if k == slack_nz:
                        s = s + 1.0
                    buf[:, host.nz_col[k] - c0] = s
                cols = np.arange(c0, min(c0 + chunk, n))
                g[:, i, cols] = buf[:, cols - c0]
                writes[i, cols] += 1
                p = q
    wr = _wr(host, w, off, r)
    rhs = np.stack([_rhs_column(host, v, wr, c) for c in range(n)], 1)
    return (g, rhs, np.broadcast_to(writes, (batch, n, n)),
            np.ones((batch, n), dtype=np.int64))


def _walk_fleet(host, v, w, off, r):
    """csrc/gain_fill.cu's fleet regime in numpy, for each group of 32
    scenarios (a lane each). First the rhs blocks: a block per RHS_COLS
    columns, a warp a column summing its terms in order for its lanes into
    shared memory, then the block's threads storing the staged elements a
    scenario's columns at a time. Then a block per band of G rows
    (``band_lists``): it sums the band's duplicated entries once into
    shared memory, a warp per nonzero sums its contributions (a duplicate
    read through its band slot, ``f_a``/``f_b``) from 0.0, and a warp per
    (row, chunk,
    quarter of the scenarios) stores the chunk whole, a lane per VEC
    columns finding its nonzero among the chunk's. Returns G, rhs and the
    write counts."""
    batch, n = len(v), host.n
    vec = 2 if n % 2 == 0 else 1
    chunk = 32 * vec
    weight = np.concatenate([w, off])
    slack_nz = _slack_nz(host)
    g = np.full((batch, n, n), np.nan)
    writes = np.zeros((batch, n, n), dtype=np.int64)
    rhs = np.full((batch, n), np.nan)
    rhs_writes = np.zeros((batch, n), dtype=np.int64)
    wr = _wr(host, w, off, r)
    bands = k8.band_lists(host)
    k8.check_bands(host, bands)
    for b0 in range(0, batch, 32):
        lanes = np.arange(b0, min(b0 + 32, batch))
        vg = v[lanes]
        for c0 in range(0, n, RHS_COLS):
            ncol = min(RHS_COLS, n - c0)
            staged = np.full((RHS_COLS, 33), np.nan)
            for warp in range(ncol):
                staged[warp, :len(lanes)] = _rhs_column(host, vg, wr[lanes],
                                                        c0 + warp)
            for x in range(32 * ncol):   # the block's threads in turn
                s, cl = divmod(x, ncol)
                if b0 + s < batch:
                    rhs[b0 + s, c0 + cl] = staged[cl, s]
                    rhs_writes[b0 + s, c0 + cl] += 1
        for band in range(len(bands.bdup_ptr) - 1):
            i0, i1 = band * bands.band, min(n, (band + 1) * bands.band)
            z0, z1 = host.nz_ptr[i0], host.nz_ptr[i1]
            d0, d1 = bands.bdup_ptr[band], bands.bdup_ptr[band + 1]
            dsum = [_entries(host, vg, -int(d) - 1)
                    for d in bands.bdup[d0:d1]]

            def value(ref):
                return vg[:, ref] if ref >= 0 else dsum[-ref - 1]

            nzv = np.zeros((z1 - z0, len(lanes)))
            for k in range(z0, z1):
                s = np.zeros(len(lanes))
                for e in range(host.c_ptr[k], host.c_ptr[k + 1]):
                    s = s + weight[host.c_w[e]] * (value(bands.f_a[e])
                                                   * value(bands.f_b[e]))
                if k == slack_nz:
                    s = s + 1.0
                nzv[k - z0] = s
            for i in range(i0, i1):
                lo, end = host.nz_ptr[i], host.nz_ptr[i + 1]
                for c0 in range(0, n, chunk):
                    p = lo + int(np.searchsorted(host.nz_col[lo:end], c0))
                    q = lo + int(np.searchsorted(host.nz_col[lo:end],
                                                 c0 + chunk))
                    row = np.zeros((len(lanes), chunk))
                    for k in range(p, q):   # each lane's scan of [p, q)
                        row[:, host.nz_col[k] - c0] = nzv[k - z0]
                    cols = np.arange(c0, min(c0 + chunk, n))
                    for part in range(4):   # the scenario quarters
                        sel = lanes[part * 8:(part + 1) * 8]
                        g[sel[:, None], i, cols] = row[sel - b0][:, cols - c0]
                        writes[sel[:, None], i, cols] += 1
    return g, rhs, writes, rhs_writes


def test_table_gives_one_writer_and_coalesces_duplicates(carried):
    c = carried
    host = c["gain_host"]
    k8.check_gain_table(host)
    # the pattern's duplicates: an injection row meets its own bus as a
    # Y-bus entry and as its diagonal pair
    key = c["rows"] * 2 * c["n"] + c["cols"]
    kept = c["cols"] != int(c["host"].slack)
    assert len(np.unique(key[kept])) == len(host.u_row) < kept.sum()
    assert len(host.dup_ptr) - 1 == len(key[kept]) - len(host.u_row)
    assert np.array_equal(host.u_row * 2 * c["n"] + host.u_col,
                          np.unique(key[kept]))
    assert not np.any(host.u_col == int(c["host"].slack))
    # every band lists the duplicates its contributions read
    bands = k8.band_lists(host)
    k8.check_bands(host, bands)
    assert np.array_equal(np.unique(bands.bdup),
                          np.arange(len(host.dup_ptr) - 1))
    # the kernel's small-B walk writes every element once, and the plain
    # version's bits
    vm, va = _state(c, 11)
    res = k3.se_fill_entries_ref(c["tarr"], c["tnet"], torch.tensor(vm),
                                 torch.tensor(va), c["tarr"].mean[None])
    table = k8.device_table(host, "cpu")
    gain, rhs = k8.gain_fill_ref(table, res.vals, c["tarr"].w,
                                 c["tarr"].pair_off, res.r)
    g, r, writes, rhs_writes = _walk_small(
        host, res.vals.numpy(), c["tarr"].w.numpy(),
        c["tarr"].pair_off.numpy(), res.r.numpy())
    assert np.all(writes == 1) and np.all(rhs_writes == 1)
    assert np.array_equal(g.view(np.int64), gain.numpy().view(np.int64))
    assert np.array_equal(r.view(np.int64), rhs.numpy().view(np.int64))
    # G is symmetric to the bit: each nonzero's order is symmetric
    assert torch.equal(gain, gain.mT)


def _odd_pattern(seed=7, n=71, m=60, e=500, slack=70):
    """A random pattern of odd order N with duplicated entries, three
    correlated pairs and a slack column (the VEC = 1 path), its tables and
    weights."""
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, m, e), rng.integers(0, n, e)
    rows = np.concatenate([rows, rows[:e // 5]])
    cols = np.concatenate([cols, cols[:e // 5]])
    perm = rng.permutation(len(rows))
    host = k8.gain_fill_table(rows[perm], cols[perm], m, n, [0, 5, 7],
                              [1, 9, 8], slack)
    return host, rng.uniform(0.5, 2.0, m), rng.uniform(-0.3, 0.3, 3)


BATCHES = (1, 5, 31, 32, 33, 64)   # both sides of k8.FLEET_MIN


def _hold_walk(regime, host, vals, w, off, r):
    """The walk of ``regime`` writes every element of G and rhs once and
    gives ``gain_fill_ref``'s bits."""
    walk = _walk_small if regime == "small" else _walk_fleet
    g, rhs, writes, rhs_writes = walk(host, vals, w, off, r)
    table = k8.device_table(host, "cpu")
    gain, want = k8.gain_fill_ref(table, torch.tensor(vals), torch.tensor(w),
                                  torch.tensor(off), torch.tensor(r))
    assert np.all(writes == 1) and np.all(rhs_writes == 1)
    assert np.array_equal(g.view(np.int64), gain.numpy().view(np.int64))
    assert np.array_equal(rhs.view(np.int64), want.numpy().view(np.int64))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("regime", ["small", "fleet"])
def test_walks_give_the_plain_bits(carried, regime, batch):
    """Both regimes of csrc/gain_fill.cu, walked in numpy at batches on
    both sides of ``FLEET_MIN``, on every row type (even N): K3's entry
    mode's values and residuals at ``batch`` random states."""
    c = carried
    vm, va = _state(c, batch, batch)
    res = k3.se_fill_entries_ref(c["tarr"], c["tnet"], torch.tensor(vm),
                                 torch.tensor(va),
                                 c["tarr"].mean.expand(batch, -1))
    _hold_walk(regime, c["gain_host"], res.vals.numpy(), c["tarr"].w.numpy(),
               c["tarr"].pair_off.numpy(), res.r.numpy())


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("regime", ["small", "fleet"])
def test_walks_give_the_plain_bits_at_odd_n(regime, batch):
    """The same at odd N (one column a lane, 8-byte stores), on a random
    pattern with duplicates, correlated pairs and a slack column."""
    host, w, off = _odd_pattern()
    assert host.n % 2 == 1 and len(host.dup_ptr) > 1
    rng = np.random.default_rng(batch)
    _hold_walk(regime, host, rng.standard_normal((batch, host.entries)), w,
               off, rng.standard_normal((batch, host.m)))


def test_band_duplicate_sums_taken_once_give_the_same_bits(carried):
    """The fleet regime sums each band's duplicated entries once
    (``bdup``) and reads a duplicate through its band slot (``f_a``,
    ``f_b``): every contribution's values, so resolved, have the bits of
    the duplicate summed anew at the reference (``entry()``), and
    the bands' sums are fewer than those references."""
    c = carried
    host = c["gain_host"]
    bands = k8.band_lists(host)
    rng = np.random.default_rng(21)
    v = rng.standard_normal((33, host.entries))
    owner = np.repeat(np.arange(len(host.nz_col)), np.diff(host.c_ptr))
    band = np.repeat(np.arange(host.n), np.diff(host.nz_ptr))[owner] \
        // bands.band
    sums = {}
    for b in range(len(bands.bdup_ptr) - 1):
        for q in range(bands.bdup_ptr[b], bands.bdup_ptr[b + 1]):
            sums[b, q - bands.bdup_ptr[b]] = _entries(
                host, v, -int(bands.bdup[q]) - 1)
    refs = 0
    for f, cu in ((bands.f_a, host.c_a), (bands.f_b, host.c_b)):
        for e in np.flatnonzero(f < 0):
            got = sums[band[e], -f[e] - 1]
            want = _entries(host, v, host.u_ref[cu[e]])
            assert np.array_equal(got.view(np.int64), want.view(np.int64))
            refs += 1
    assert refs > 0 and len(sums) < refs


def test_fleet_bands_built_once_at_first_use(carried):
    """A table carries no band lists until the fleet regime asks for them
    (a single estimate never builds them); ``fleet_bands`` then builds the
    checked lists once, on the table's device, for as long as it lives;
    ``check_bands`` refuses a list that misses a reference."""
    host = carried["gain_host"]
    table = k8.device_table(host, "cpu")
    assert k8._CACHE.get(table.nz_ptr) is None
    bands = k8.fleet_bands(table)
    assert k8.fleet_bands(table) is bands
    want = k8.band_lists(host)
    for name in ("f_a", "f_b", "bdup_ptr", "bdup"):
        got = getattr(bands, name)
        assert got.dtype == torch.int32 and got.device == table.nz_ptr.device
        assert np.array_equal(got.numpy(), getattr(want, name))
    assert bands.band == want.band
    assert k8.fleet_shared(table) <= k8.BAND_SHARED
    dup = np.flatnonzero(want.f_a < 0)[0]
    bad = want.f_a.copy()
    bad[dup] = -(np.diff(want.bdup_ptr).max() + 1)   # past its band's list
    with pytest.raises(ValueError, match="duplicate list"):
        k8.check_bands(host, want._replace(f_a=bad))


def test_plain_versions_take_the_scenario_minor_layout(carried):
    """At FLEET_MIN scenarios and more K3's entry-mode plain version gives
    the values scenario-minor (strides (1, B)) with the bits of the
    row-major values a scenario at a time, and K8's plain version gives
    the same bits from either layout."""
    c = carried
    batch = k8.FLEET_MIN + 1
    assert k8.scenario_minor(batch) and not k8.scenario_minor(batch - 2)
    vm, va = _state(c, 23, batch)
    vm, va = torch.tensor(vm), torch.tensor(va)
    mean = c["tarr"].mean.expand(batch, -1)
    res = k3.se_fill_entries(c["tarr"], c["tnet"], vm, va, mean)
    assert res.vals.stride() == (1, batch) and res.vals.mT.is_contiguous()
    for b in (0, 7, batch - 1):
        one = k3.se_fill_entries(c["tarr"], c["tnet"], vm[b:b + 1],
                                 va[b:b + 1], mean[b:b + 1])
        assert one.vals.is_contiguous()
        for name in ("h", "r", "vals"):
            assert torch.equal(getattr(one, name)[0].view(torch.int64),
                               getattr(res, name)[b].view(torch.int64))
    table = torch_acse.gain_table(c["tarr"], c["tnet"])
    w, off = c["tarr"].w, c["tarr"].pair_off
    minor = k8.gain_fill(table, res.vals, w, off, res.r)
    row = k8.gain_fill(table, res.vals.contiguous(), w, off, res.r)
    for a, b in zip(minor, row):
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    assert minor[0].is_contiguous() and minor[0].shape == (batch, table.n,
                                                           table.n)


def test_wrapper_refuses_other_layouts(carried):
    """K8 takes the values row-major or scenario-minor and raises on any
    other strides (on the CPU as on the card): it never copies them."""
    c = carried
    batch = 3
    vm, va = _state(c, 29, batch)
    res = k3.se_fill_entries(c["tarr"], c["tnet"], torch.tensor(vm),
                             torch.tensor(va),
                             c["tarr"].mean.expand(batch, -1))
    table = torch_acse.gain_table(c["tarr"], c["tnet"])
    w, off = c["tarr"].w, c["tarr"].pair_off
    wide = torch.zeros(batch, 2 * table.entries, dtype=torch.float64)
    wide[:, ::2] = res.vals
    assert k8.value_strides(res.vals) == (1, table.entries)
    assert k8.value_strides(res.vals.mT.contiguous().mT) == (batch, 1)
    for bad in (wide[:, ::2], wide[:, :table.entries]):
        with pytest.raises(ValueError, match="row-major"):
            k8.gain_fill(table, bad, w, off, res.r)
    torch.testing.assert_close(k8.gain_fill(table, wide[:, ::2].clone(), w,
                                            off, res.r)[0],
                               k8.gain_fill(table, res.vals, w, off,
                                            res.r)[0], rtol=0, atol=0)


@pytest.mark.parametrize("bad,match", [
    (dict(ent_rows=[0, 5]), "outside"),
    (dict(pair_r1=[0, 1], pair_r2=[1, 2]), "at most one pair"),
    (dict(pair_r1=[1], pair_r2=[1]), "at most one pair"),
    (dict(slack=4), "slack"),
])
def test_table_refuses_bad_patterns(bad, match):
    args = dict(ent_rows=[0, 1], ent_cols=[0, 1], m=3, n=4, pair_r1=(),
                pair_r2=(), slack=-1)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        k8.gain_fill_table(**args)


# --------------------------------------------------------------------------
# The gain against the JAX package's pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("edit", [False, True])
def test_gain_matches_jax_formula(carried, edit):
    """G and rhs at a random state; ``edit``: after a variance edit of
    every tenth row (new w, the same table)."""
    c = carried
    vm, va = _state(c, 3)
    jarr, tarr = c["jarr"], c["tarr"]
    if edit:
        w = np.asarray(c["host"].w).copy()
        w[::10] *= 7.5
        jarr = jarr._replace(w=jnp.asarray(w))
        tarr = tarr._replace(w=torch.tensor(w))
    want = _jax_gain(c, vm[0], va[0], jarr)
    got = _port_gain(c, vm, va, tarr)
    _assert_gain([x[0].numpy() for x in got], want)


def test_entry_mode_matches_jax_masked_vals(carried):
    """K3's entry mode: h, r and ``vals * status[ent_rows] *
    col_mask[ent_cols]`` of ``gn_increment``, for 3 scenarios."""
    c = carried
    vm, va = _state(c, 5, batch=3)
    rng = np.random.default_rng(6)
    means = (c["host"].mean[None]
             + 0.01 * rng.standard_normal((3, len(c["host"].mean))))
    got = k3.se_fill_entries(c["tarr"], c["tnet"], torch.tensor(vm),
                             torch.tensor(va), torch.tensor(means))
    n = c["n"]
    col_mask = jnp.ones(2 * n).at[c["jarr"].slack].set(0.0)
    rows, cols = jnp.asarray(c["rows"]), jnp.asarray(c["cols"])
    for b in range(3):
        vals, h = jax_acse.h_entries(c["jarr"], c["jnet"], jnp.asarray(vm[b]),
                                     jnp.asarray(va[b]))
        vals = vals * c["jarr"].status[rows] * col_mask[cols]
        np.testing.assert_allclose(got.vals[b].numpy(), np.asarray(vals),
                                   **ENTRY_TOL)
        np.testing.assert_allclose(got.h[b].numpy(), np.asarray(h),
                                   **ENTRY_TOL)
        np.testing.assert_allclose(got.r[b].numpy(), means[b] - np.asarray(h),
                                   **ENTRY_TOL)
    assert got.vals.shape == (3, c["tarr"].desc.entries)


def test_entry_positions_walk_the_pattern(carried):
    """csrc/se_fill.cu's entry mode in numpy: the positions each row's puts
    reach (``epos[slot, row]``, an injection row's Y entry k at ``epos[0 or
    1, row] + k``) hold the pattern's (row, column) and cover it once."""
    c = carried
    host, n = c["host"], c["n"]
    epos, entries = k3.entry_positions(host)
    assert entries == len(c["rows"])
    idx, _ = k3.se_fill_table(host)
    row_ptr = c["tnet"].row_ptr.numpy()
    ycols = c["tnet"].cols.numpy()
    hits = np.zeros(entries, dtype=np.int64)

    def put(row, col, pos):
        assert c["rows"][pos] == row and c["cols"][pos] == col
        hits[pos] += 1

    for row in range(len(host.mean)):
        code, f, t = idx[:, row]
        if code in (k3.P_INJ, k3.Q_INJ):
            for k in range(row_ptr[f], row_ptr[f + 1]):
                put(row, ycols[k], epos[0, row] + k)
                put(row, n + ycols[k], epos[1, row] + k)
            put(row, f, epos[2, row])
            put(row, n + f, epos[3, row])
        elif code == k3.VM:
            put(row, n + f, epos[0, row])
        elif code == k3.VA:
            put(row, f, epos[0, row])
        elif code in (k3.RE_V, k3.IM_V):
            put(row, f, epos[0, row])
            put(row, n + f, epos[1, row])
        else:
            for slot, col in enumerate((f, t, n + f, n + t)):
                put(row, col, epos[slot, row])
    assert np.all(hits == 1)
    assert np.array_equal(c["tarr"].desc.epos.numpy(), epos)


# --------------------------------------------------------------------------
# Whole paths against the JAX package
# --------------------------------------------------------------------------

def _scada_pmu(pkg, system, pf):
    """SCADA, correlated PMUs at the buses and one wattmeter out of
    service."""
    mon = pkg.measurement(system)
    pkg.add_voltmeter(mon, analysis=pf)
    pkg.add_wattmeter(mon, analysis=pf)
    pkg.add_varmeter(mon, analysis=pf)
    pkg.add_pmu(mon, analysis=pf, correlated=True, status_from=-1,
                status_to=-1)
    pkg.update_wattmeter(mon, mon.wattmeter.label.label(2), status=0)
    return mon


@pytest.fixture(scope="module", params=CASES)
def scada(request, data_path):
    """A case with ``_scada_pmu``'s set, compiled by the JAX package and
    carried into the port."""
    system = jg.power_system(str(data_path / f"{request.param}.m"))
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True, current=True)
    jarr, _, _, host = jax_acse.compile_se_arrays(
        system, _scada_pmu(jg, system, pf), return_host=True)
    jnet = jax_ac.compile_ac_arrays(system)
    tnet = ac_arrays_from_numpy(
        **{f: np.asarray(getattr(jnet, f)) for f in jnet._fields},
        device="cpu")
    return dict(jarr=jarr, jnet=jnet, tarr=se_arrays_from_numpy(host, "cpu"),
                tnet=tnet, host=host, n=system.bus.number,
                vm=np.asarray(pf.voltage.magnitude),
                va=np.asarray(pf.voltage.angle))


def test_gn_increment_matches_jax(scada):
    c = scada
    vm, va = _state(c, 7)
    want = jax_acse.gn_increment(c["jarr"], c["jnet"], jnp.asarray(vm[0]),
                                 jnp.asarray(va[0]), "LU")
    got = torch_acse.gn_increment(c["tarr"], c["tnet"], torch.tensor(vm[0]),
                                  torch.tensor(va[0]), "LU")
    assert np.abs(np.asarray(want[0])).max() > 1e-4
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **STATE_TOL)
    assert float(got[2]) < 1e-10


@pytest.mark.parametrize("case", CASES)
def test_state_estimation_matches_jax(data_path, case):
    """``state_estimation`` of SCADA + correlated PMUs with a wattmeter out
    of service: the same iterations, states within 1e-9."""
    path = str(data_path / f"{case}.m")
    runs = []
    for pkg, dev in ((jg, {}), (jgt, {"device": "cpu"})):
        system = pkg.power_system(path)
        pf = pkg.newton_raphson(system, **dev)
        pkg.power_flow(pf, power=True, current=True)
        se = pkg.gauss_newton(_scada_pmu(pkg, system, pf), **dev)
        pkg.state_estimation(se)
        runs.append(se)
    ref, port = runs
    assert port.method.converged and ref.method.converged
    assert port.method.iteration == ref.method.iteration
    np.testing.assert_allclose(port.voltage.magnitude,
                               np.asarray(ref.voltage.magnitude), **STATE_TOL)
    np.testing.assert_allclose(port.voltage.angle,
                               np.asarray(ref.voltage.angle), **STATE_TOL)


def test_batched_se_solve_matches_jax(scada):
    """8 scenarios of means around the set's from seed 3, every scenario
    from the power-flow state with noise: counts equal, states 1e-9."""
    c = scada
    host = c["host"]
    rng = np.random.default_rng(3)
    means = host.mean[None] + 0.5 / np.sqrt(host.w)[None] * \
        rng.standard_normal((8, len(host.mean)))
    vm0, va0 = _state(c, 9, batch=8)
    jvm, jva, jit, jconv = batched_se_solve_jit(
        c["jarr"], c["jnet"], jnp.asarray(vm0), jnp.asarray(va0),
        jnp.asarray(means), tol=1e-8, max_iter=40)
    tvm, tva, tit, tconv = batched_se_solve(
        c["tarr"], c["tnet"], torch.tensor(vm0), torch.tensor(va0),
        torch.tensor(means))
    assert np.array_equal(tconv.numpy(), np.asarray(jconv))
    assert np.array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_allclose(tvm.numpy(), np.asarray(jvm), **STATE_TOL)
    np.testing.assert_allclose(tva.numpy(), np.asarray(jva), **STATE_TOL)


# --------------------------------------------------------------------------
# DC and PMU estimators
# --------------------------------------------------------------------------

def _linear_sets(data_path, case, kind):
    """The JAX package's DC (wattmeters, one out of service) or PMU
    (correlated at the buses, branch PMUs, one out of service) arrays and
    their port from the same fields."""
    system = jg.power_system(str(data_path / f"{case}.m"))
    mon = jg.measurement(system)
    if kind == "dc":
        pf = jg.dc_power_flow(system)
        jg.power_flow(pf, power=True)
        jg.add_wattmeter(mon, analysis=pf)
        jg.update_wattmeter(mon, mon.wattmeter.label.label(4), status=0)
        jarr = jax_dcse.compile_dcse_arrays(system, mon)[0]
        tarr = dcse_arrays_from_numpy(
            **{f: np.asarray(getattr(jarr, f)) for f in jarr._fields},
            device="cpu")
    else:
        pf = jg.newton_raphson(system)
        jg.power_flow(pf, power=True, current=True)
        jg.add_pmu(mon, analysis=pf, correlated=True, status_from=-1,
                   status_to=-1)
        jg.add_pmu(mon, analysis=pf, status_bus=-1)
        jg.update_pmu(mon, mon.pmu.label.label(system.bus.number + 3),
                      status=0)
        jarr = jax_pmuse.compile_pmuse_arrays(system, mon)[0]
        tarr = pmuse_arrays_from_numpy(
            **{f: np.asarray(getattr(jarr, f)) for f in jarr._fields},
            device="cpu")
    return jarr, tarr


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["dc", "pmu"])
def test_linear_gain_and_solve_match_jax(data_path, case, kind):
    jarr, tarr = _linear_sets(data_path, case, kind)
    h = np.asarray(jarr.h_dense)
    w = np.asarray(jarr.w)
    if kind == "dc":
        col_mask = np.ones(h.shape[1])
        col_mask[int(jarr.slack)] = 0.0
        hm = h * col_mask
        want = (hm.T @ (w[:, None] * hm) + np.diag(1.0 - col_mask),
                hm.T @ (w * np.asarray(jarr.mean)))
        got = torch_dcse._dcse_normal_equations(tarr)
        solve = (torch_dcse._dcse_solve(tarr, "LU").numpy(),
                 np.asarray(jax_dcse._dcse_solve(jarr, "LU")))
    else:
        wh, wz = jax_acse._weighted(jarr, jnp.asarray(h),
                                    jnp.asarray(jarr.mean))
        want = (h.T @ np.asarray(wh), h.T @ np.asarray(wz))
        assert np.asarray(jarr.pair_r1).size
        got = torch_pmuse._pmuse_normal_equations(tarr)
        solve = (np.stack([x.numpy() for x in
                           torch_pmuse._pmuse_solve(tarr, "LU")]),
                 np.stack([np.asarray(x) for x in
                           jax_pmuse._pmuse_solve(jarr, "LU")]))
    _assert_gain([x.numpy() for x in got], want)
    np.testing.assert_allclose(*solve, **STATE_TOL)


# --------------------------------------------------------------------------
# Bits, the cache, dispatch and build
# --------------------------------------------------------------------------

def test_plain_version_gives_the_same_bits_twice(carried):
    c = carried
    vm, va = _state(c, 13, batch=2)
    one = _port_gain(c, vm, va)
    two = _port_gain(c, vm, va)
    for a, b in zip(one, two):
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_table_reused_after_value_edit_rebuilt_after_add(data_path):
    system = jgt.power_system(str(data_path / "case14test.m"))
    pf = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(pf, power=True, current=True)
    mon = _scada_pmu(jgt, system, pf)
    se = jgt.gauss_newton(mon, device="cpu")
    jgt.state_estimation(se)
    table = torch_acse.gain_table(se.arrays, se.net)
    assert torch_acse.gain_table(se.arrays, se.net) is table
    jgt.update_wattmeter(mon, mon.wattmeter.label.label(1), variance=1e-2,
                         status=0)
    jgt.state_estimation(se)
    assert torch_acse.gain_table(se.arrays, se.net) is table
    jgt.add_voltmeter(mon, bus=system.bus.label.label(4), magnitude=1.0)
    jgt.state_estimation(se)
    again = torch_acse.gain_table(se.arrays, se.net)
    assert again is not table and again.m == table.m + 1


def test_wrappers_check_inputs_and_dispatch(carried):
    c = carried
    vm, va = _state(c, 17, batch=2)
    res = k3.se_fill_entries(c["tarr"], c["tnet"], torch.tensor(vm),
                             torch.tensor(va), c["tarr"].mean[None].repeat(
                                 2, 1))
    table = torch_acse.gain_table(c["tarr"], c["tnet"])
    before = (k3.se_fill_entries.launches, k8.gain_fill.launches)
    k8.gain_fill(table, res.vals, c["tarr"].w, c["tarr"].pair_off, res.r)
    assert (k3.se_fill_entries.launches, k8.gain_fill.launches) == before
    w, off = c["tarr"].w, c["tarr"].pair_off
    with pytest.raises(ValueError, match="vals must have shape"):
        k8.gain_fill(table, res.vals[:, :-1], w, off, res.r)
    with pytest.raises(ValueError, match="pair_off must have shape"):
        k8.gain_fill(table, res.vals, w, off[:0], res.r)
    with pytest.raises(TypeError, match="float64"):
        k8.gain_fill(table, res.vals.float(), w, off, res.r)
    with pytest.raises(ValueError, match="no entry positions"):
        k3.se_fill_entries(c["tarr"]._replace(desc=c["tarr"].desc._replace(
            epos=None)), c["tnet"], torch.tensor(vm), torch.tensor(va),
            c["tarr"].mean[None].repeat(2, 1))


def test_build_flags_and_sources():
    assert "-fmad=false" in _build.nvcc_flags("gain_fill")
    assert _build.sources("gain_fill") == [_build.CSRC / "gain_fill.cu"]
    assert _build.library_path("gain_fill").parent == _build.BUILD_DIR
    # the numpy walks' constants are the source's
    src = (_build.CSRC / "gain_fill.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kSpan"]) == SPAN
    assert int(const["kThreads"]) // int(const["kWarp"]) == RHS_COLS
    assert int(const["kGroup"]) == 32 and int(const["kParts"]) == 4
