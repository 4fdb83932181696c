"""Independent sparse CPU reference implementation (oracle).

A pure numpy/scipy re-implementation of the reference's numerical stack
*shape* (serial sparse CSC assembly + UMFPACK/KLU-class factorization; here
scipy ``splu``). It is validated against the shipped MATPOWER goldens for
IEEE 14/30 (exact iteration counts and voltages), which qualifies it to
check the port's Newton-Raphson on grids where no shipped oracle exists.

Independence: only the host data model and parsers are shared with the
port. Y-bus assembly, mismatch evaluation, Jacobian construction and the
linear algebra are all implemented here separately (complex-matrix
formulation), so agreement with the tensor path is a genuine cross-check.

Reference parity anchors: powerFlow/acPowerFlow.jl:645-911 (NR).
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
