"""K8 ``gain_fill`` and K3's entry mode: their plain PyTorch versions
against the JAX package on the CPU.

The same measurement sets (case14test, case30test, case118 with every row
type, correlated PMU pairs and inactive rows), compiled by the JAX package
and carried across, go through the JAX package's pieces and the port's:

- K8's tables give every element of G and of rhs one writer and coalesce
  the pattern's duplicate entries (a numpy walk of ``csrc/gain_fill.cu``'s
  chunk stream, which also gives the plain version's bits);
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

def _walk_kernel(host, vals, w, off, r):
    """csrc/gain_fill.cu in numpy, one scenario: a warp per G row streams
    the row in chunks of 32 VEC columns, a lane per nonzero sums its
    contributions sequentially from 0.0 into the chunk, lane 0 sums rhs.
    Returns G, rhs and how often each element of each was written."""
    n, m = host.n, host.m
    vec = 2 if n % 2 == 0 else 1
    chunk = 32 * vec
    coalesced = np.zeros(len(host.u_row))
    for u, ref in enumerate(host.u_ref):
        if ref >= 0:
            coalesced[u] = vals[ref]
        else:
            s = 0.0
            d = -ref - 1
            for q in range(host.dup_ptr[d], host.dup_ptr[d + 1]):
                s += vals[host.dup_raw[q]]
            coalesced[u] = s
    weight = np.concatenate([w, off])
    g = np.full((n, n), np.nan)
    writes = np.zeros((n, n), dtype=np.int64)
    rhs = np.zeros(n)
    rhs_writes = np.zeros(n, dtype=np.int64)
    for i in range(n):
        s = 0.0
        for q in range(host.col_ptr[i], host.col_ptr[i + 1]):
            u = host.col_u[q]
            row = host.u_row[u]
            wr = w[row] * r[row]
            if host.pair_of[row] >= 0:
                wr = wr + off[host.pair_of[row]] * r[host.partner[row]]
            s += coalesced[u] * wr
        rhs[i] = s
        rhs_writes[i] += 1
        p, end = host.nz_ptr[i], host.nz_ptr[i + 1]
        for c0 in range(0, n, chunk):
            q = p
            while q < end and host.nz_col[q] < c0 + chunk:
                q += 1
            buf = np.zeros(chunk)
            for k in range(p, q):
                j = host.nz_col[k]
                s = 0.0
                for e in range(host.c_ptr[k], host.c_ptr[k + 1]):
                    s += weight[host.c_w[e]] * (coalesced[host.c_a[e]]
                                                * coalesced[host.c_b[e]])
                if i == host.slack and j == host.slack:
                    s += 1.0
                buf[j - c0] = s
            for lane in range(32):
                for v in range(vec):
                    col = c0 + vec * lane + v
                    if col < n:
                        g[i, col] = buf[vec * lane + v]
                        writes[i, col] += 1
            p = q
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
    # the kernel's walk writes every element once, and the plain
    # version's bits
    vm, va = _state(c, 11)
    res = k3.se_fill_entries_ref(c["tarr"], c["tnet"], torch.tensor(vm),
                                 torch.tensor(va), c["tarr"].mean[None])
    table = k8.device_table(host, "cpu")
    gain, rhs = k8.gain_fill_ref(table, res.vals, c["tarr"].w,
                                 c["tarr"].pair_off, res.r)
    g, r, writes, rhs_writes = _walk_kernel(
        host, res.vals[0].numpy(), c["tarr"].w.numpy(),
        c["tarr"].pair_off.numpy(), res.r[0].numpy())
    assert np.all(writes == 1) and np.all(rhs_writes == 1)
    assert np.array_equal(g.view(np.int64), gain[0].numpy().view(np.int64))
    assert np.array_equal(r.view(np.int64), rhs[0].numpy().view(np.int64))
    # G is symmetric to the bit: each nonzero's order is symmetric
    assert torch.equal(gain, gain.mT)


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
