"""Independent sparse CPU reference implementation (oracle).

A pure numpy/scipy re-implementation of the reference's numerical stack
*shape* (serial sparse CSC assembly + UMFPACK/KLU-class factorization; here
scipy ``splu``). It is validated against the shipped MATPOWER goldens for
IEEE 14/30 (exact iteration counts and voltages), which qualifies it to
check the port's Newton-Raphson, fast decoupled (``oracle_fdpf``) and DC
(``oracle_dc``) power flows on grids where no shipped oracle exists;
``oracle_wls_se`` checks the port's Gauss-Newton WLS state estimation the
same way on SCADA and polar bus PMU sets.

Independence: only the host data model and parsers are shared with the
port. Y-bus assembly, mismatch evaluation, Jacobian construction and the
linear algebra are all implemented here separately (complex-matrix
formulation), so agreement with the tensor path is a genuine cross-check.

Reference parity anchors: powerFlow/acPowerFlow.jl:645-911 (NR),
:913-983 (fast decoupled), dcPowerFlow.jl:89-134 (DC),
stateEstimation/acStateEstimation.jl:261-931 (WLS SE).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import splu

from ..system.types import PowerSystem


def oracle_ybus(system: PowerSystem) -> sp.csc_matrix:
    """Assemble the bus admittance matrix from branch/bus data
    (independent of system/model.py; same pi-model convention:
    reference powerSystem/model.jl:23-78)."""
    n = system.bus.number
    m = system.branch.number
    br = system.branch
    f = br.layout.from_bus.array[:m]
    t = br.layout.to_bus.array[:m]
    on = br.layout.status.array[:m] == 1

    prm = br.parameter
    with np.errstate(divide="ignore", invalid="ignore"):
        ys = np.where(on, 1.0 / (prm.resistance.array[:m]
                                 + 1j * prm.reactance.array[:m]), 0.0)
    ysh = prm.conductance.array[:m] + 1j * prm.susceptance.array[:m]
    tau = prm.turns_ratio.array[:m]
    phi = prm.shift_angle.array[:m]
    a = np.exp(-1j * phi) / tau

    ytt = np.where(on, ys + 0.5 * ysh, 0.0)
    yff = ytt / tau**2
    yft = np.where(on, -np.conj(a) * ys, 0.0)
    ytf = np.where(on, -a * ys, 0.0)

    dsh = (system.bus.shunt.conductance.array[:n]
           + 1j * system.bus.shunt.susceptance.array[:n])
    rows = np.concatenate([np.arange(n), f, t, f, t])
    cols = np.concatenate([np.arange(n), t, f, f, t])
    vals = np.concatenate([dsh, yft, ytf, yff, ytt])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()


def _scheduled(system: PowerSystem):
    n = system.bus.number
    bus = system.bus
    p = bus.supply.active.array[:n] - bus.demand.active.array[:n]
    q = bus.supply.reactive.array[:n] - bus.demand.reactive.array[:n]
    return p, q


def _start_voltages(system: PowerSystem):
    """Start state per the reference's initializeACPowerFlow rules
    (acPowerFlow.jl:1312-1331): case-file voltages; PV/slack magnitudes
    seeded from the first in-service generator setpoint; PV buses without
    generators degrade to PQ."""
    from ..powerflow.ac import initialize_ac_power_flow
    return initialize_ac_power_flow(system)


def oracle_nr(system: PowerSystem, tolerance: float = 1e-8,
              iteration: int = 20) -> SimpleNamespace:
    """Sparse Newton-Raphson power flow, MATPOWER-style complex Jacobian,
    CSC + splu. Iteration semantics match the reference driver
    (acPowerFlow.jl:1389-1433): mismatch, check, solve."""
    n = system.bus.number
    ybus = oracle_ybus(system)
    p_sched, q_sched = _scheduled(system)
    vm, va = _start_voltages(system)
    types = system.bus.layout.type.array[:n]
    slack = system.bus.layout.slack

    pq = np.flatnonzero(types == 1)
    pvpq = np.flatnonzero(np.arange(n) != slack)
    npv = len(pvpq)

    def mismatch(v):
        s = v * np.conj(ybus @ v)
        dp = s.real - p_sched
        dq = s.imag - q_sched
        return dp, dq, np.max(np.abs(dp[pvpq])), np.max(np.abs(dq[pq]))

    v = vm * np.exp(1j * va)
    dp, dq, del_p, del_q = mismatch(v)
    it = 0
    while not (del_p < tolerance and del_q < tolerance) and it < iteration:
        ibus = ybus @ v
        diag_v = sp.diags(v)
        diag_i = sp.diags(ibus)
        diag_vn = sp.diags(v / np.abs(v))
        ds_dva = 1j * diag_v @ np.conj(diag_i - ybus @ diag_v)
        ds_dvm = diag_v @ np.conj(ybus @ diag_vn) + np.conj(diag_i) @ diag_vn

        j11 = ds_dva[pvpq, :][:, pvpq].real
        j12 = ds_dvm[pvpq, :][:, pq].real
        j21 = ds_dva[pq, :][:, pvpq].imag
        j22 = ds_dvm[pq, :][:, pq].imag
        jac = sp.bmat([[j11, j12], [j21, j22]], format="csc")
        rhs = np.concatenate([dp[pvpq], dq[pq]])
        dx = splu(jac).solve(rhs)

        va = np.angle(v)
        vm = np.abs(v)
        va[pvpq] -= dx[:npv]
        vm[pq] -= dx[npv:]
        v = vm * np.exp(1j * va)
        it += 1
        dp, dq, del_p, del_q = mismatch(v)

    return SimpleNamespace(
        magnitude=np.abs(v), angle=np.angle(v), iterations=it,
        converged=bool(del_p < tolerance and del_q < tolerance),
        max_mismatch_active=float(del_p), max_mismatch_reactive=float(del_q))


def _fdpf_matrices(system: PowerSystem, bx: bool):
    """Sparse B'/B'' per the reference BX/XB coefficient rules
    (acPowerFlow.jl:416-483), assembled independently in COO->CSC."""
    n = system.bus.number
    m = system.branch.number
    br = system.branch
    prm = br.parameter
    f = br.layout.from_bus.array[:m]
    t = br.layout.to_bus.array[:m]
    on = br.layout.status.array[:m] == 1

    r = prm.resistance.array[:m]
    x = prm.reactance.array[:m]
    bsi = 0.5 * prm.susceptance.array[:m]
    tau_inv = 1.0 / prm.turns_ratio.array[:m]
    phi = prm.shift_angle.array[:m]
    sin_p, cos_p = np.sin(phi), np.cos(phi)
    with np.errstate(divide="ignore", invalid="ignore"):
        y = np.where(on, 1.0 / (r + 1j * x), 0.0)
        inv_x = np.where(on, -1.0 / x, 0.0)
    if bx:
        bmk = inv_x
        p_a, p_b = y.real, y.imag
    else:
        bmk = y.imag
        p_a = np.zeros(m)
        p_b = inv_x

    denom = cos_p**2 + sin_p**2
    pij = np.where(on, (-p_a * sin_p - p_b * cos_p) / denom, 0.0)
    pji = np.where(on, (p_a * sin_p - p_b * cos_p) / denom, 0.0)
    pii = np.where(on, p_b / denom, 0.0)
    pjj = np.where(on, p_b, 0.0)

    q_a = np.where(on, -bmk * tau_inv, 0.0)
    q_b = np.where(on, (bmk + bsi) * tau_inv**2, 0.0)
    q_c = np.where(on, bmk + bsi, 0.0)

    rows = np.concatenate([f, t, f, t])
    cols = np.concatenate([t, f, f, t])
    bp = sp.coo_matrix((np.concatenate([pij, pji, pii, pjj]),
                        (rows, cols)), shape=(n, n)).tocsc()
    bq = sp.coo_matrix((np.concatenate([q_a, q_a, q_b, q_c]),
                        (rows, cols)), shape=(n, n)).tocsc()
    bq = bq + sp.diags(system.bus.shunt.susceptance.array[:n])
    return bp, bq


def _mask_identity(a: sp.csc_matrix, active: np.ndarray) -> sp.csc_matrix:
    """Inactive rows/cols -> identity (the slack/non-PQ masking trick)."""
    d = sp.diags(active.astype(np.float64))
    return (d @ a @ d + sp.diags(1.0 - active.astype(np.float64))).tocsc()


def oracle_fdpf(system: PowerSystem, bx: bool = True,
                tolerance: float = 1e-8, iteration: int = 30
                ) -> SimpleNamespace:
    """Fast-decoupled power flow with constant sparse B'/B'' factors
    (the reference's half-iteration scheme, acPowerFlow.jl:913-983)."""
    n = system.bus.number
    ybus = oracle_ybus(system).tocsr()
    p_sched, q_sched = _scheduled(system)
    vm, va = _start_voltages(system)
    types = system.bus.layout.type.array[:n]
    slack = system.bus.layout.slack
    m_p = np.arange(n) != slack
    m_q = types == 1

    bp, bq = _fdpf_matrices(system, bx)
    f_p = splu(_mask_identity(bp, m_p))
    f_q = splu(_mask_identity(bq, m_q))

    def injections(vm, va):
        v = vm * np.exp(1j * va)
        s = v * np.conj(ybus @ v)
        return s.real, s.imag

    def mism(vm, va):
        p, q = injections(vm, va)
        mp = np.where(m_p, (p - p_sched) / vm, 0.0)
        mq = np.where(m_q, (q - q_sched) / vm, 0.0)
        return mp, mq, np.max(np.abs(mp)), np.max(np.abs(mq))

    mp, mq, del_p, del_q = mism(vm, va)
    it = 0
    while not (del_p < tolerance and del_q < tolerance) and it < iteration:
        dva = f_p.solve(mp)
        va = va + np.where(m_p, dva, 0.0)
        p, q = injections(vm, va)
        mq = np.where(m_q, (q - q_sched) / vm, 0.0)
        dvm = f_q.solve(mq)
        vm = vm + np.where(m_q, dvm, 0.0)
        it += 1
        mp, mq, del_p, del_q = mism(vm, va)

    return SimpleNamespace(
        magnitude=vm, angle=va, iterations=it,
        converged=bool(del_p < tolerance and del_q < tolerance),
        max_mismatch_active=float(del_p), max_mismatch_reactive=float(del_q))


def _branch_admittances(system: PowerSystem):
    """Per-branch two-port admittance blocks (yff, yft, ytf, ytt) and
    endpoint indices — independent assembly, same pi-model convention as
    ``oracle_ybus``."""
    m = system.branch.number
    br = system.branch
    f = br.layout.from_bus.array[:m]
    t = br.layout.to_bus.array[:m]
    on = br.layout.status.array[:m] == 1
    prm = br.parameter
    with np.errstate(divide="ignore", invalid="ignore"):
        ys = np.where(on, 1.0 / (prm.resistance.array[:m]
                                 + 1j * prm.reactance.array[:m]), 0.0)
    ysh = prm.conductance.array[:m] + 1j * prm.susceptance.array[:m]
    tau = prm.turns_ratio.array[:m]
    a = np.exp(-1j * prm.shift_angle.array[:m]) / tau
    ytt = np.where(on, ys + 0.5 * ysh, 0.0)
    yff = ytt / tau**2
    yft = np.where(on, -np.conj(a) * ys, 0.0)
    ytf = np.where(on, -a * ys, 0.0)
    return f, t, yff, yft, ytf, ytt


def _collect_se_rows(system: PowerSystem, monitoring):
    """Flatten the active measurement set into (kind, idx, z, w) row lists.

    Covers the SCADA+PMU set used by the scale benchmarks: voltmeters,
    watt/varmeters (injection + from/to flows), and polar bus PMUs (which
    contribute an extra |V| row and a Va row). Ammeters, branch PMUs and
    rectangular/correlated PMUs are outside this oracle's scope (the
    port handles them; see estimation/acse.py) and raise."""
    kinds, idxs, z, w, row_device = [], [], [], [], []

    def push(kind, idx, mean, var, status, device=None):
        if status != 1:
            return
        kinds.append(kind)
        idxs.append(int(idx))
        z.append(float(mean))
        w.append(1.0 / float(var))
        row_device.append(device)

    volt = monitoring.voltmeter
    for k in range(volt.number):
        push("vm", volt.layout.index.array[k],
             volt.magnitude.mean.array[k], volt.magnitude.variance.array[k],
             volt.magnitude.status.array[k], ("voltmeter", k))
    if monitoring.ammeter.number:
        raise ValueError("ammeters are outside the oracle's scope")
    watt = monitoring.wattmeter
    for k in range(watt.number):
        lay = watt.layout
        kind = ("pinj" if lay.bus.array[k]
                else "pf" if lay.from_.array[k] else "pt")
        push(kind, lay.index.array[k], watt.active.mean.array[k],
             watt.active.variance.array[k], watt.active.status.array[k],
             ("wattmeter", k))
    var_ = monitoring.varmeter
    for k in range(var_.number):
        lay = var_.layout
        kind = ("qinj" if lay.bus.array[k]
                else "qf" if lay.from_.array[k] else "qt")
        push(kind, lay.index.array[k], var_.reactive.mean.array[k],
             var_.reactive.variance.array[k], var_.reactive.status.array[k],
             ("varmeter", k))
    pmu = monitoring.pmu
    for k in range(pmu.number):
        lay = pmu.layout
        if not (lay.bus.array[k] and lay.polar.array[k]):
            raise ValueError("only polar bus PMUs are in the oracle's scope")
        push("vm", lay.index.array[k], pmu.magnitude.mean.array[k],
             pmu.magnitude.variance.array[k], pmu.magnitude.status.array[k],
             ("pmu", k))
        push("va", lay.index.array[k], pmu.angle.mean.array[k],
             pmu.angle.variance.array[k], pmu.angle.status.array[k],
             ("pmu", k))
    return (np.array(kinds), np.array(idxs, dtype=np.int64),
            np.array(z), np.array(w), row_device)


def oracle_wls_se(system: PowerSystem, monitoring, tolerance: float = 1e-8,
                  iteration: int = 40) -> SimpleNamespace:
    """Sparse Gauss-Newton WLS state estimation: per-iteration sparse H
    fill, normal-equation gain G = HᵀWH in CSC, splu refactorization —
    the reference solve shape (acStateEstimation.jl:261-931 with the
    KLU/CHOLMOD substrate of backend/utility.jl:470-562).

    Iteration semantics mirror the port's ``_se_solve`` (and the
    reference's stateEstimation!): compute increment, loop while max|dx| >= tol
    applying-then-recomputing, counting applications."""
    n = system.bus.number
    ybus = oracle_ybus(system).tocsr()
    f, t, yff, yft, ytf, ytt = _branch_admittances(system)
    kinds, idxs, z, w, row_device = _collect_se_rows(system, monitoring)
    m = len(z)
    slack = system.bus.layout.slack

    vm = system.bus.voltage.magnitude.array[:n].copy()
    va = system.bus.voltage.angle.array[:n].copy()

    sel = {k: np.flatnonzero(kinds == k) for k in
           ("vm", "va", "pinj", "qinj", "pf", "qf", "pt", "qt")}

    def build(vm, va):
        """Vectorized sparse H fill + h(x) (no Python per-row loops —
        the baseline must be a fair serial-CPU implementation)."""
        v = vm * np.exp(1j * va)
        h = np.zeros(m)
        blocks_r, blocks_c, blocks_v = [], [], []

        def add(r, c, d):
            blocks_r.append(np.asarray(r, dtype=np.int64))
            blocks_c.append(np.asarray(c, dtype=np.int64))
            blocks_v.append(np.asarray(d, dtype=np.float64))

        if len(sel["vm"]):
            bus = idxs[sel["vm"]]
            h[sel["vm"]] = vm[bus]
            add(sel["vm"], n + bus, np.ones(len(bus)))
        if len(sel["va"]):
            bus = idxs[sel["va"]]
            h[sel["va"]] = va[bus]
            add(sel["va"], bus, np.ones(len(bus)))

        if len(sel["pinj"]) or len(sel["qinj"]):
            ibus = ybus @ v
            s = v * np.conj(ibus)
            diag_v = sp.diags(v)
            ds_dva = (1j * diag_v @ np.conj(
                sp.diags(ibus) - ybus @ diag_v)).tocsr()
            ds_dvm = (diag_v @ np.conj(ybus @ sp.diags(v / np.abs(v)))
                      + np.conj(sp.diags(ibus)) @ sp.diags(
                          v / np.abs(v))).tocsr()
            for key, part in (("pinj", np.real), ("qinj", np.imag)):
                rows_k = sel[key]
                if not len(rows_k):
                    continue
                bus = idxs[rows_k]
                h[rows_k] = part(s[bus])
                for mat, off in ((ds_dva, 0), (ds_dvm, n)):
                    sub = mat[bus, :].tocoo()
                    add(rows_k[sub.row], off + sub.col, part(sub.data))

        for keys, from_side in ((("pf", "qf"), True), (("pt", "qt"), False)):
            rows_k = np.concatenate([sel[k] for k in keys])
            if not len(rows_k):
                continue
            br = idxs[rows_k]
            i = (f if from_side else t)[br]
            j = (t if from_side else f)[br]
            ya = (yff if from_side else ytt)[br]
            yb = (yft if from_side else ytf)[br]
            sij = v[i] * np.conj(ya * v[i] + yb * v[j])
            cross = np.conj(yb) * v[i] * np.conj(v[j])
            d_ti = 1j * (sij - np.conj(ya) * vm[i] ** 2)
            d_tj = -1j * cross
            d_vi = sij / vm[i] + np.conj(ya) * vm[i]
            d_vj = cross / vm[j]
            real = np.isin(rows_k, sel[keys[0]])
            h[rows_k] = np.where(real, sij.real, sij.imag)
            for c, dv in ((i, d_ti), (j, d_tj),
                          (n + i, d_vi), (n + j, d_vj)):
                add(rows_k, c, np.where(real, dv.real, dv.imag))

        H = sp.coo_matrix(
            (np.concatenate(blocks_v),
             (np.concatenate(blocks_r), np.concatenate(blocks_c))),
            shape=(m, 2 * n)).tocsr()
        return H, h

    def increment(vm, va):
        H, h = build(vm, va)
        # mask the slack angle column, pin dx[slack] = 0 via identity
        keep = np.ones(2 * n)
        keep[slack] = 0.0
        H = (H @ sp.diags(keep)).tocsc()
        r = z - h
        wh = sp.diags(w) @ H
        gain = (H.T @ wh + sp.diags(1.0 - keep)).tocsc()
        dx = splu(gain).solve(H.T @ (w * r))
        return dx, np.max(np.abs(dx))

    dx, maxinc = increment(vm, va)
    it = 0
    while maxinc >= tolerance and it < iteration:
        va = va + dx[:n]
        vm = vm + dx[n:]
        it += 1
        dx, maxinc = increment(vm, va)

    H, h = build(vm, va)
    return SimpleNamespace(
        magnitude=vm, angle=va, iterations=it,
        converged=bool(maxinc < tolerance), max_increment=float(maxinc),
        jacobian=H, residual=z - h, weights=w, slack=slack,
        row_device=row_device)


def oracle_dc(system: PowerSystem) -> SimpleNamespace:
    """DC power flow: B theta = P with slack row/col masked to identity
    (reference dcPowerFlow.jl:89-134)."""
    from ..system.model import model
    model(system, "dc")
    n = system.bus.number
    bus = system.bus
    # independent B assembly
    m = system.branch.number
    br = system.branch
    f = br.layout.from_bus.array[:m]
    t = br.layout.to_bus.array[:m]
    on = br.layout.status.array[:m] == 1
    with np.errstate(divide="ignore"):
        adm = np.where(on, 1.0 / (br.parameter.turns_ratio.array[:m]
                                  * br.parameter.reactance.array[:m]), 0.0)
    rows = np.concatenate([f, t, f, t])
    cols = np.concatenate([t, f, f, t])
    vals = np.concatenate([-adm, -adm, adm, adm])
    b = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()

    phi = br.parameter.shift_angle.array[:m]
    shift = phi * adm
    shift_power = np.zeros(n)
    np.subtract.at(shift_power, f, shift)
    np.add.at(shift_power, t, shift)

    slack = bus.layout.slack
    rhs = (bus.supply.active.array[:n] - bus.demand.active.array[:n]
           - bus.shunt.conductance.array[:n] - shift_power)
    active = np.arange(n) != slack
    rhs = np.where(active, rhs, 0.0)
    theta = splu(_mask_identity(b, active)).solve(rhs)
    theta = theta + bus.voltage.angle.array[:n][slack] - theta[slack]
    return SimpleNamespace(angle=theta)
