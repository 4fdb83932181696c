"""Observability analysis: flow/maximal islands, Gram restoration, and
optimal PMU placement.

A copy of ``juliagrid_tpu/estimation/observability.py`` (numpy and scipy
only). Host-side graph algorithms matching JuliaGrid
src/stateEstimation/observability.jl: flow-observable islands from paired
P/Q flow measurements via connected components (:84-160), tie
bus/branch/injection tracking (:162-184), island merging by single-incidence injections (mergePairs,
:186-271) and by minimal injection combinations (mergeFlowIslands +
decision-tree search, :273-458); observability restoration through the
reduced island-level Gram matrix and QR zero-pivot test (restorationGram!,
:460-602); optimal PMU placement as an ILP set cover (:730-937) solved by
scipy's in-process HiGHS MILP (the reference calls HiGHS/GLPK via JuMP).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations

import numpy as np
import scipy.sparse as sp

from ..system.model import model
from ..system.types import PowerSystem


@dataclass
class TieData:
    bus: set = field(default_factory=set)
    branch: set = field(default_factory=set)
    injection: set = field(default_factory=set)


@dataclass
class Island:
    island: list = field(default_factory=list)   # list of bus-index lists
    bus: np.ndarray = None                       # bus -> island id
    tie: TieData = field(default_factory=TieData)


def _adjacency(system: PowerSystem):
    """Y-bus pattern neighbor lists (reference connectionObservability)."""
    model(system, "ac")
    nodal = system.model.ac.nodal.copy()
    nodal.eliminate_zeros()
    n = system.bus.number
    indptr = nodal.indptr
    indices = nodal.indices
    return [indices[indptr[i]:indptr[i + 1]] for i in range(n)]


def _flow_components(system: PowerSystem, monitoring) -> Island:
    """Connected components over branches carrying in-service flow
    wattmeters (reference connectedComponents)."""
    n = system.bus.number
    watt = monitoring.wattmeter
    rows, cols = [], []
    for i in range(watt.number):
        k = int(watt.layout.index[i])
        if (not watt.layout.bus[i] and watt.active.status[i] == 1
                and system.branch.layout.status[k] == 1):
            rows.append(int(system.branch.layout.from_bus[k]))
            cols.append(int(system.branch.layout.to_bus[k]))
    adj = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    ncomp, labels = sp.csgraph.connected_components(adj, directed=False)
    islands = [[] for _ in range(ncomp)]
    for b, c in enumerate(labels):
        islands[c].append(b)
    return Island(island=islands, bus=labels.astype(np.int64))


def _tie_bus_branch(system: PowerSystem, observe: Island):
    observe.tie.bus = set()
    observe.tie.branch = set()
    m = system.branch.number
    for i in range(m):
        f = int(system.branch.layout.from_bus[i])
        t = int(system.branch.layout.to_bus[i])
        if observe.bus[f] != observe.bus[t]:
            observe.tie.branch.add(i)
            observe.tie.bus.add(f)
            observe.tie.bus.add(t)


def _tie_injection(observe: Island, monitoring):
    watt = monitoring.wattmeter
    observe.tie.injection = set()
    for i in range(watt.number):
        k = int(watt.layout.index[i])
        if (watt.layout.bus[i] and watt.active.status[i] == 1
                and k in observe.tie.bus):
            observe.tie.injection.add(k)


def _renumber(observe: Island):
    """Compact island ids after merging."""
    keep = [isl for isl in observe.island if isl]
    observe.island = keep
    for k, isl in enumerate(keep):
        for b in isl:
            observe.bus[b] = k


def _merge_pairs(observe: Island, adjacency):
    """Merge islands joined by injections incident to at most one other
    island (reference mergePairs, observability.jl:186-271)."""
    merged = True
    while merged and len(observe.island) > 1:
        merged = False
        for bus_idx in list(observe.tie.injection):
            own = observe.bus[bus_idx]
            incident = {int(observe.bus[j]) for j in adjacency[bus_idx]
                        if observe.bus[j] != own}
            if len(incident) <= 1:
                if len(incident) == 1:
                    other = incident.pop()
                    observe.island[own].extend(observe.island[other])
                    for b in observe.island[other]:
                        observe.bus[b] = own
                    observe.island[other] = []
                observe.tie.injection.discard(bus_idx)
                merged = True
    _renumber(observe)


def _merge_flow_islands(system: PowerSystem, observe: Island, adjacency):
    """Merge islands via minimal injection combinations (reference
    mergeFlowIslands + decisionTree, :273-458)."""
    while True:
        ties = sorted(observe.tie.injection)
        incident = []
        for b in ties:
            nb = set(adjacency[b]) | {b}
            incident.append(sorted({int(observe.bus[j]) for j in nb}))

        merge_set = None
        for t in range(2, len(incident) + 1):
            for combo in combinations(range(len(incident)), t):
                union = set()
                for c in combo:
                    union.update(incident[c])
                if len(union) == t + 1:
                    merge_set = union
                    break
            if merge_set:
                break
        if not merge_set:
            break

        ids = sorted(merge_set)
        first = ids[0]
        for other in ids[1:]:
            observe.island[first].extend(observe.island[other])
            for b in observe.island[other]:
                observe.bus[b] = first
            observe.island[other] = []
        _renumber(observe)

        for b in list(observe.tie.injection):
            nb = set(adjacency[b]) | {b}
            if len({int(observe.bus[j]) for j in nb}) == 1:
                observe.tie.injection.discard(b)

        _merge_pairs(observe, adjacency)

    # final tie cleanup
    observe.tie.bus = set()
    if len(observe.island) > 1:
        for i in list(observe.tie.branch):
            f = int(system.branch.layout.from_bus[i])
            t = int(system.branch.layout.to_bus[i])
            if observe.bus[f] == observe.bus[t]:
                observe.tie.branch.discard(i)
            else:
                observe.tie.bus.add(f)
                observe.tie.bus.add(t)
    else:
        observe.tie.branch = set()


def island_topological_flow(monitoring) -> Island:
    """Reference islandTopologicalFlow (observability.jl:25-39)."""
    system = monitoring.system
    adjacency = _adjacency(system)
    observe = _flow_components(system, monitoring)
    _tie_bus_branch(system, observe)
    _tie_injection(observe, monitoring)
    _merge_pairs(observe, adjacency)
    _tie_bus_branch(system, observe)
    return observe


def island_topological(monitoring) -> Island:
    """Reference islandTopological (observability.jl:68-82)."""
    system = monitoring.system
    adjacency = _adjacency(system)
    observe = _flow_components(system, monitoring)
    _tie_bus_branch(system, observe)
    _tie_injection(observe, monitoring)
    _merge_pairs(observe, adjacency)
    _merge_flow_islands(system, observe, adjacency)
    return observe


def restoration_gram(monitoring, pseudo, islands: Island,
                     threshold: float = 1e-5):
    """Reference restorationGram! (observability.jl:460-602): build the
    island-level reduced Jacobian, take its Gram matrix, and promote the
    pseudo-measurements whose QR pivots exceed the threshold."""
    from ..measurement.devices import add_pmu, add_varmeter, add_wattmeter

    system = monitoring.system
    adjacency = _adjacency(system)
    n_islands = len(islands.island)

    rows, cols, vals = [], [], []
    row = -1

    def add_tie_row(bus_idx):
        nonlocal row
        row += 1
        own = int(islands.bus[bus_idx])
        outside = [int(islands.bus[j]) for j in adjacency[bus_idx]
                   if islands.bus[j] != own]
        for isl in outside:
            rows.append(row)
            cols.append(isl)
            vals.append(-1.0)
        rows.append(row)
        cols.append(own)
        vals.append(float(len(outside)))

    def add_direct(island_id):
        nonlocal row
        row += 1
        rows.append(row)
        cols.append(island_id)
        vals.append(1.0)

    def add_indirect(from_isl, to_isl):
        nonlocal row
        row += 1
        rows.append(row)
        cols.append(from_isl)
        vals.append(1.0)
        rows.append(row)
        cols.append(to_isl)
        vals.append(-1.0)

    for bus_idx in sorted(islands.tie.injection):
        add_tie_row(bus_idx)
    pmu_m = monitoring.pmu
    for i in range(pmu_m.number):
        if (pmu_m.layout.bus[i] and pmu_m.angle.status[i] == 1
                and pmu_m.magnitude.status[i] == 1):
            add_direct(int(islands.bus[int(pmu_m.layout.index[i])]))
    add_direct(int(islands.bus[system.bus.layout.slack]))
    number_tie = row + 1

    watt_p = pseudo.wattmeter
    var_p = pseudo.varmeter
    pmu_p = pseudo.pmu
    pseudo_device = []   # ("power", watt idx) or ("pmu", pmu idx)
    for i in range(watt_p.number):
        if watt_p.active.status[i] != 1:
            continue
        k = int(watt_p.layout.index[i])
        if watt_p.layout.bus[i]:
            if k in islands.tie.bus:
                add_tie_row(k)
                pseudo_device.append(("power", i))
        else:
            if k in islands.tie.branch \
                    and system.branch.layout.status[k] == 1:
                add_indirect(int(islands.bus[system.branch.layout.from_bus[k]]),
                             int(islands.bus[system.branch.layout.to_bus[k]]))
                pseudo_device.append(("power", i))
    for i in range(pmu_p.number):
        if (pmu_p.layout.bus[i] and pmu_p.angle.status[i] == 1
                and pmu_p.magnitude.status[i] == 1):
            add_direct(int(islands.bus[int(pmu_p.layout.index[i])]))
            pseudo_device.append(("pmu", i))

    total_rows = row + 1
    reduced = sp.coo_matrix((vals, (rows, cols)),
                            shape=(total_rows, n_islands)).toarray()
    gram = reduced @ reduced.T
    r_mat = np.linalg.qr(gram, mode="r")

    for k, i in enumerate(range(number_tie, total_rows)):
        if abs(r_mat[i, i]) > threshold:
            kind, idx = pseudo_device[k]
            if kind == "power":
                k_el = int(watt_p.layout.index[idx])
                w_label = watt_p.label.label(idx)
                if w_label in monitoring.wattmeter.label:
                    w_label = None  # pseudo label collides; auto-number
                v_label = var_p.label.label(idx) if idx < var_p.number \
                    else None
                if v_label is not None and v_label \
                        in monitoring.varmeter.label:
                    v_label = None
                if watt_p.layout.bus[idx]:
                    bus_label = system.bus.label.label(k_el)
                    add_wattmeter(monitoring, w_label, bus=bus_label,
                                  active=watt_p.active.mean[idx],
                                  variance=watt_p.active.variance[idx],
                                  status=1)
                    if v_label is not None:
                        add_varmeter(monitoring, v_label, bus=bus_label,
                                     reactive=var_p.reactive.mean[idx],
                                     variance=var_p.reactive.variance[idx],
                                     status=1)
                else:
                    br_label = system.branch.label.label(k_el)
                    loc = ("from_branch" if watt_p.layout.from_[idx]
                           else "to_branch")
                    add_wattmeter(monitoring, w_label,
                                  **{loc: br_label},
                                  active=watt_p.active.mean[idx],
                                  variance=watt_p.active.variance[idx],
                                  status=1)
                    if v_label is not None:
                        add_varmeter(monitoring, v_label,
                                     **{loc: br_label},
                                     reactive=var_p.reactive.mean[idx],
                                     variance=var_p.reactive.variance[idx],
                                     status=1)
            else:
                bus_label = system.bus.label.label(
                    int(pmu_p.layout.index[idx]))
                p_label = pmu_p.label.label(idx)
                if p_label in monitoring.pmu.label:
                    p_label = None
                add_pmu(monitoring, p_label, bus=bus_label,
                        magnitude=pmu_p.magnitude.mean[idx],
                        angle=pmu_p.angle.mean[idx],
                        variance_magnitude=pmu_p.magnitude.variance[idx],
                        variance_angle=pmu_p.angle.variance[idx], status=1)
    return monitoring


@dataclass
class PmuPlacement:
    bus: dict = field(default_factory=dict)      # bus label -> index
    from_: dict = field(default_factory=dict)    # branch label -> index
    to: dict = field(default_factory=dict)


def pmu_placement(monitoring, legacy: bool = False) -> PmuPlacement:
    """Reference pmuPlacement (observability.jl:730-937): minimum PMU set
    cover ILP solved by scipy's in-process HiGHS."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    system = monitoring.system
    model(system, "ac")
    n = system.bus.number
    adjacency = _adjacency(system)

    a_rows, a_cols, a_vals, lbs = [], [], [], []
    rix = 0
    if legacy:
        watt = monitoring.wattmeter
        incident = np.zeros(n, dtype=bool)
        for i in range(watt.number):
            if watt.active.status[i] != 1:
                continue
            k = int(watt.layout.index[i])
            rhs = -1
            if watt.layout.bus[i]:
                members = adjacency[k]
            else:
                members = [int(system.branch.layout.from_bus[k]),
                           int(system.branch.layout.to_bus[k])]
            counts = {}
            for b in members:
                incident[b] = True
                rhs += 1
                for h in adjacency[b]:
                    counts[h] = counts.get(h, 0) + 1
            for c, v in counts.items():
                a_rows.append(rix)
                a_cols.append(c)
                a_vals.append(float(v))
            lbs.append(float(rhs))
            rix += 1
        for b in range(n):
            if not incident[b]:
                for h in adjacency[b]:
                    a_rows.append(rix)
                    a_cols.append(h)
                    a_vals.append(1.0)
                lbs.append(1.0)
                rix += 1
    else:
        for b in range(n):
            for h in adjacency[b]:
                a_rows.append(rix)
                a_cols.append(h)
                a_vals.append(1.0)
            lbs.append(1.0)
            rix += 1

    a = sp.coo_matrix((a_vals, (a_rows, a_cols)), shape=(rix, n)).toarray()
    res = milp(
        c=np.ones(n),
        constraints=LinearConstraint(a, lb=np.asarray(lbs), ub=np.inf),
        integrality=np.ones(n),
        bounds=Bounds(0, 1))
    if not res.success:
        raise RuntimeError(f"PMU placement ILP failed: {res.message}")
    chosen = np.flatnonzero(np.round(res.x) == 1)

    placement = PmuPlacement()
    for b in chosen:
        placement.bus[system.bus.label.label(int(b))] = int(b)
        for k in range(system.branch.number):
            if system.branch.layout.status[k] != 1:
                continue
            if int(system.branch.layout.from_bus[k]) == b:
                placement.from_[system.branch.label.label(k)] = k
            if int(system.branch.layout.to_bus[k]) == b:
                placement.to[system.branch.label.label(k)] = k
    return placement


def pmu_placement_apply(monitoring, analysis, legacy: bool = False,
                        **pmu_kwargs) -> PmuPlacement:
    """Reference pmuPlacement! (observability.jl:939-995): place PMUs and
    instantiate them with values from a solved AC analysis."""
    from ..measurement.devices import add_pmu
    from ..postprocessing.ac import current as ac_current

    placement = pmu_placement(monitoring, legacy=legacy)
    if analysis.current is None:
        ac_current(analysis)
    for bus_label, idx in placement.bus.items():
        add_pmu(monitoring, bus=bus_label,
                magnitude=float(analysis.voltage.magnitude[idx]),
                angle=float(analysis.voltage.angle[idx]), **pmu_kwargs)
    for br_label, idx in placement.from_.items():
        add_pmu(monitoring, from_branch=br_label,
                magnitude=float(analysis.current.from_.magnitude[idx]),
                angle=float(analysis.current.from_.angle[idx]), **pmu_kwargs)
    for br_label, idx in placement.to.items():
        add_pmu(monitoring, to_branch=br_label,
                magnitude=float(analysis.current.to.magnitude[idx]),
                angle=float(analysis.current.to.angle[idx]), **pmu_kwargs)
    return placement
