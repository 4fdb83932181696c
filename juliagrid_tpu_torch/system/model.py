"""AC/DC nodal model assembly and incremental updates.

Vectorized numpy/scipy equivalent of JuliaGrid src/powerSystem/model.jl:
``acModel!`` (:23-78), ``dcModel!`` (:161-212), incremental nodal updates
(:81-132, :215-262), ``dropZeros!`` (:331-352), and ``physicalIsland``
(:375-463). Assembly runs on host once per pattern change; solvers consume
frozen snapshots. The branch pi-model convention matches the reference:

    y  = 1/(r + jx),  ys = g + jb (line charging / magnetizing),
    a  = (1/τ) e^{-jφ}   (complex tap on the *from* side)
    Y_tt = y + ys/2
    Y_ff = Y_tt / τ²
    Y_ft = -conj(a) y
    Y_tf = -a y
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .types import PowerSystem


def ac_model(system: PowerSystem) -> None:
    """Build the bus admittance matrix and per-branch two-port parameters."""
    ac = system.model.ac
    n = system.bus.number
    m = system.branch.number

    f = system.branch.layout.from_bus.array[:m]
    t = system.branch.layout.to_bus.array[:m]
    status = system.branch.layout.status.array[:m].astype(np.float64)

    r = system.branch.parameter.resistance.array[:m]
    x = system.branch.parameter.reactance.array[:m]
    gs = system.branch.parameter.conductance.array[:m]
    bs = system.branch.parameter.susceptance.array[:m]
    tau = system.branch.parameter.turns_ratio.array[:m]
    phi = system.branch.parameter.shift_angle.array[:m]

    with np.errstate(divide="ignore", invalid="ignore"):
        y = np.where(status == 1, 1.0 / (r + 1j * x), 0.0 + 0.0j)
    shunt = gs + 1j * bs
    tau_inv = 1.0 / tau
    a = tau_inv * np.exp(-1j * phi)

    ytt = np.where(status == 1, y + 0.5 * shunt, 0.0)
    yff = tau_inv**2 * ytt
    yft = np.where(status == 1, -np.conj(a) * y, 0.0)
    ytf = np.where(status == 1, -a * y, 0.0)

    ac.admittance = np.where(status == 1, y, 0.0)
    ac.nodal_from_from = yff
    ac.nodal_from_to = yft
    ac.nodal_to_from = ytf
    ac.nodal_to_to = ytt

    diag = (system.bus.shunt.conductance.array[:n]
            + 1j * system.bus.shunt.susceptance.array[:n])

    # Structural zeros for out-of-service branches are kept in the pattern
    # (reference keeps the slot and zeros the stamp, model.jl:251-262) so a
    # later status flip is a value-only update.
    rows = np.concatenate([np.arange(n), f, t, f, t])
    cols = np.concatenate([np.arange(n), t, f, f, t])
    vals = np.concatenate([diag, yft, ytf, yff, ytt])
    nodal = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    nodal.sum_duplicates()
    ac.nodal = nodal


def dc_model(system: PowerSystem) -> None:
    """Build B' matrix, branch DC admittance, and shift-angle power injections."""
    dc = system.model.dc
    n = system.bus.number
    m = system.branch.number

    f = system.branch.layout.from_bus.array[:m]
    t = system.branch.layout.to_bus.array[:m]
    status = system.branch.layout.status.array[:m]
    x = system.branch.parameter.reactance.array[:m]
    tau = system.branch.parameter.turns_ratio.array[:m]
    phi = system.branch.parameter.shift_angle.array[:m]

    with np.errstate(divide="ignore"):
        adm = np.where(status == 1, 1.0 / (tau * x), 0.0)
    dc.admittance = adm

    shift = phi * adm
    shift_power = np.zeros(n)
    np.subtract.at(shift_power, f, shift)
    np.add.at(shift_power, t, shift)
    dc.shift_power = shift_power

    rows = np.concatenate([np.arange(n), f, t, f, t])
    cols = np.concatenate([np.arange(n), t, f, f, t])
    vals = np.concatenate([np.zeros(n), -adm, -adm, adm, adm])
    nodal = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    nodal.sum_duplicates()
    dc.nodal = nodal


def model(system: PowerSystem, kind: str = "both") -> None:
    """Lazy model build (reference ``model!``, model.jl:135,:265)."""
    if kind in ("ac", "both") and system.model.ac.nodal is None:
        ac_model(system)
    if kind in ("dc", "both") and system.model.dc.nodal is None:
        dc_model(system)


# ---------------------------------------------------------------------------
# Incremental ± stamps (reference acNodalUpdate!/acParameterUpdate!,
# model.jl:81-132, DC twins :215-262): a single-branch edit subtracts the
# old stamp, refreshes the per-branch two-port parameters, and adds the new
# stamp — O(log nnz) CSR element updates instead of the O(nnz + m) full
# reassembly. Possible because the assembly keeps out-of-service branches
# as structural zeros (model.jl:251-262 trick), so even status flips never
# change the pattern.
# ---------------------------------------------------------------------------

def ac_parameter_update(system: PowerSystem, idx: int) -> None:
    """Refresh one branch's stored two-port stamp from its current
    parameters (reference acParameterUpdate!, model.jl:113-132) — the same
    closed forms as the vectorized ``ac_model`` assembly."""
    ac = system.model.ac
    br = system.branch
    st = int(br.layout.status[idx])
    if st != 1:
        z = 0.0 + 0.0j
        ac.admittance[idx] = z
        ac.nodal_from_from[idx] = z
        ac.nodal_from_to[idx] = z
        ac.nodal_to_from[idx] = z
        ac.nodal_to_to[idx] = z
        return
    r = float(br.parameter.resistance[idx])
    x = float(br.parameter.reactance[idx])
    gs = float(br.parameter.conductance[idx])
    bs = float(br.parameter.susceptance[idx])
    tau = float(br.parameter.turns_ratio[idx])
    phi = float(br.parameter.shift_angle[idx])
    # numpy scalar division under errstate so a zero-impedance branch
    # yields the same value the vectorized ac_model assembly produces
    # instead of raising ZeroDivisionError mid-update
    with np.errstate(divide="ignore", invalid="ignore"):
        y = complex(np.complex128(1.0) / np.complex128(complex(r, x)))
    tau_inv = 1.0 / tau
    a = tau_inv * np.exp(-1j * phi)
    ytt = y + 0.5 * (gs + 1j * bs)
    ac.admittance[idx] = y
    ac.nodal_from_from[idx] = tau_inv ** 2 * ytt
    ac.nodal_from_to[idx] = -np.conj(a) * y
    ac.nodal_to_from[idx] = -a * y
    ac.nodal_to_to[idx] = ytt


def dc_parameter_update(system: PowerSystem, idx: int) -> None:
    """Refresh one branch's stored DC admittance from its parameters."""
    dc = system.model.dc
    br = system.branch
    st = int(br.layout.status[idx])
    x = float(br.parameter.reactance[idx])
    tau = float(br.parameter.turns_ratio[idx])
    with np.errstate(divide="ignore", invalid="ignore"):
        dc.admittance[idx] = \
            float(np.float64(1.0) / np.float64(tau * x)) if st == 1 else 0.0


def ac_nodal_update(system: PowerSystem, idx: int, sign: float = 1.0) -> None:
    """Add (sign=+1) or subtract (sign=-1) one branch's stamp from Y-bus.

    Reference ``acNodalUpdate!`` (model.jl:81-110). The pattern keeps the
    slots, so this is value-only; bumps ac_model revision.
    """
    ac = system.model.ac
    i = int(system.branch.layout.from_bus[idx])
    j = int(system.branch.layout.to_bus[idx])
    nodal = ac.nodal.tolil() if not sp.issparse(ac.nodal) else ac.nodal
    nodal[i, i] += sign * ac.nodal_from_from[idx]
    nodal[j, j] += sign * ac.nodal_to_to[idx]
    nodal[i, j] += sign * ac.nodal_from_to[idx]
    nodal[j, i] += sign * ac.nodal_to_from[idx]
    system.ac_model_changed()


def dc_nodal_update(system: PowerSystem, idx: int, sign: float = 1.0) -> None:
    """Reference ``dcNodalUpdate!`` (model.jl:215-238)."""
    dc = system.model.dc
    i = int(system.branch.layout.from_bus[idx])
    j = int(system.branch.layout.to_bus[idx])
    adm = sign * dc.admittance[idx]
    dc.nodal[i, i] += adm
    dc.nodal[j, j] += adm
    dc.nodal[i, j] -= adm
    dc.nodal[j, i] -= adm
    system.dc_model_changed()


def dc_shift_update(system: PowerSystem, idx: int, sign: float = 1.0) -> None:
    """Reference ``dcShiftUpdate!`` (model.jl:241-251)."""
    dc = system.model.dc
    shift = sign * system.branch.parameter.shift_angle[idx] * dc.admittance[idx]
    dc.shift_power[int(system.branch.layout.from_bus[idx])] -= shift
    dc.shift_power[int(system.branch.layout.to_bus[idx])] += shift
    system.dc_model_changed()


def drop_zeros(system: PowerSystem) -> None:
    """Remove structural zeros from nodal matrices (reference dropZeros!)."""
    changed = False
    for mdl in (system.model.ac, system.model.dc):
        if mdl.nodal is not None:
            before = mdl.nodal.nnz
            mdl.nodal.eliminate_zeros()
            changed |= mdl.nodal.nnz != before
    if changed:
        system.ac_pattern_changed()
        system.dc_pattern_changed()


def physical_island(system: PowerSystem) -> list[list[int]]:
    """Connected components over in-service branches.

    Reference ``physicalIsland`` (model.jl:375-463): BFS over the in-service
    branch graph; returns islands as lists of bus indices.
    """
    n = system.bus.number
    m = system.branch.number
    f = system.branch.layout.from_bus.array[:m]
    t = system.branch.layout.to_bus.array[:m]
    on = system.branch.layout.status.array[:m] == 1

    adj = sp.coo_matrix(
        (np.ones(int(on.sum())), (f[on], t[on])), shape=(n, n))
    ncomp, labels = sp.csgraph.connected_components(adj, directed=False)
    islands: list[list[int]] = [[] for _ in range(ncomp)]
    for bus, c in enumerate(labels):
        islands[c].append(bus)
    return islands
