"""Gauss-Seidel AC power flow on PyTorch tensors.

Port of ``juliagrid_tpu/powerflow/gauss_seidel.py`` (after JuliaGrid
src/powerFlow/acPowerFlow.jl:563-619 for the set-up, :732-764 for the
mismatch on PQ/PV buses and :985-1041 for the sequential sweep: PQ update,
PV update with the computed reactive injection, PV magnitude reprojection).

The sweep is sequential in bus order, but PQ bus i reads the new values only
of its PQ neighbours j < i (PV buses likewise among PV buses), so the buses
fall into levels: ``level(i) = 1 + max level(j)`` over those neighbours.
No two buses of one level are adjacent, and sweeping level by level computes
the sequential sweep exactly. ``level_schedule`` builds the levels on the
host. A whole solve, the JAX package's ``lax.while_loop`` of sweeps and
mismatches, is one launch of the hand-written CUDA kernel K4
(``kernels/gs_sweep.py``), which walks the levels in one thread-block
cluster, and one readback. Complex arithmetic is carried as explicit
(re, im) f64 pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.gs_sweep import gs_sweep
from ..ops import linalg
from ..system.model import model
from ..system.types import PowerSystem
from .ac import (AcPowerFlow, MethodState, Polar, ac_entry_host,
                 initialize_ac_power_flow)


class GsArrays(NamedTuple):
    """Device snapshot of the network for K4."""

    nb: torch.Tensor       # i32[n, dmax] padded neighbour indices
    yre: torch.Tensor      # f64[n, dmax] Re(Y row), 0-padded
    yim: torch.Tensor      # f64[n, dmax]
    dre: torch.Tensor      # f64[n] Re(Y_ii)
    dim: torch.Tensor      # f64[n]
    bus_type: torch.Tensor  # i32[n] 1 PQ, 2 PV, 3 slack
    slack: int
    p_sched: torch.Tensor  # f64[n]
    q_sched: torch.Tensor  # f64[n]
    vg: torch.Tensor       # f64[n] PV magnitude setpoint (1.0 elsewhere)
    pq: torch.Tensor       # i32[npq] PQ buses, ascending: the PQ pass
    pv: torch.Tensor       # i32[npv] PV buses, ascending: the PV pass
    pq_order: torch.Tensor  # i32[npq] PQ buses by (level, index)
    pq_ptr: torch.Tensor   # i32[L_pq + 1] offsets of the PQ levels
    pv_order: torch.Tensor  # i32[npv] PV buses by (level, index)
    pv_ptr: torch.Tensor   # i32[L_pv + 1] offsets of the PV levels
    widest: int            # buses of the widest level


def row_counts(nb) -> np.ndarray:
    """Y-bus entries of each row of the padded table: a row lists its
    entries in ascending column order, then pads with zeros, so its entries
    are its strictly increasing prefix."""
    nb = np.asarray(nb)
    rising = np.diff(nb, axis=1) > 0
    ends = np.concatenate([rising, np.zeros((len(nb), 1), bool)], axis=1)
    return 1 + np.argmin(ends, axis=1)


def level_schedule(nb, counts, bus_type, kind: int):
    """``(order, ptr)``: the buses of type ``kind`` sorted by (level, index)
    and the offsets of the levels, where ``level(i) = 1 + max level(j)``
    over the neighbours ``j < i`` of the same type (0 without one). A
    neighbour is any of the first ``counts[i]`` entries of row ``i``, the
    Y-bus pattern, zero admittances of branches out of service included;
    the padding behind them orders nothing. A level's buses are never
    adjacent, and every same-type neighbour with a higher index sits at a
    higher level."""
    nb = np.asarray(nb)
    is_kind = np.asarray(bus_type) == kind
    n = len(is_kind)
    rows, pos = np.nonzero(np.arange(nb.shape[1])
                           < np.asarray(counts)[:, None])
    cols = nb[rows, pos]
    keep = is_kind[rows] & is_kind[cols] & (cols < rows)
    rows, cols = rows[keep], cols[keep].tolist()
    ptr = np.searchsorted(rows, np.arange(n + 1)).tolist()
    level = [0] * n
    buses = np.flatnonzero(is_kind)
    for i in buses.tolist():
        top = 0
        for j in cols[ptr[i]:ptr[i + 1]]:
            top = max(top, level[j] + 1)
        level[i] = top
    lev = np.asarray(level, dtype=np.int64)[buses]
    order = buses[np.argsort(lev, kind="stable")]
    return order, np.concatenate([[0], np.cumsum(np.bincount(lev))])


def compile_gs_arrays(system: PowerSystem, device=None) -> GsArrays:
    """``GsArrays`` on ``device``: the padded neighbour table of the sorted
    Y-bus entry list (each row's entries in column order, zero-padded to the
    widest row), the per-bus values and the level schedule, built on the
    host."""
    # convert.py builds GsArrays from numpy and imports this module
    from ..convert import gs_arrays_from_numpy

    model(system, "ac")
    n = system.bus.number
    bus = system.bus
    rows, cols, vals, diag = ac_entry_host(system)
    counts = np.bincount(rows, minlength=n)
    dmax = int(counts.max())
    # position of each entry within its row (the list is sorted by row)
    pos = np.arange(len(rows)) - (np.cumsum(counts) - counts)[rows]
    nb = np.zeros((n, dmax), dtype=np.int32)
    yre = np.zeros((n, dmax))
    yim = np.zeros((n, dmax))
    nb[rows, pos] = cols
    yre[rows, pos] = vals.real
    yim[rows, pos] = vals.imag

    vg = np.ones(n)
    for i, gens in bus.supply.generator.items():
        if gens and bus.layout.type[i] != 1:
            vg[i] = system.generator.voltage.magnitude[gens[0]]

    return gs_arrays_from_numpy(
        nb=nb, yre=yre, yim=yim, dre=vals.real[diag], dim=vals.imag[diag],
        bus_type=bus.layout.type.array[:n], slack=bus.layout.slack,
        p_sched=bus.supply.active.array[:n] - bus.demand.active.array[:n],
        q_sched=(bus.supply.reactive.array[:n]
                 - bus.demand.reactive.array[:n]),
        vg=vg, device=device)


def _to_rect(vm, va):
    return vm * torch.cos(va), vm * torch.sin(va)


def _to_polar(vre, vim):
    return torch.sqrt(vre**2 + vim**2), torch.atan2(vim, vre)


def _gs_solve(arr: GsArrays, vm, va, tol: float, max_iter: int,
              sweep=gs_sweep):
    """Full Gauss-Seidel loop (the mismatch, then sweeps and mismatches
    until both maxima are under ``tol`` or ``max_iter`` sweeps are done) in
    one K4 launch, and one readback of its mismatch pair, sweep count and
    flag. ``sweep`` exists so a check can run the same loop on
    ``gs_sweep_ref``; the main path never passes it."""
    res = sweep(arr, *_to_rect(vm, va), max_sweeps=max_iter, tol=tol)
    del_p, del_q, it, converged = res.info.tolist()
    return (*_to_polar(res.vre, res.vim), int(it), del_p, del_q,
            bool(converged))


def gauss_seidel(system: PowerSystem, factorization: str = linalg.LU,
                 device=None) -> AcPowerFlow:
    """Reference gaussSeidel (acPowerFlow.jl:563-619) on ``device``
    (default ``config.device``)."""
    device = resolve_device(device)
    system.check_slack()
    model(system, "ac")
    magnitude, angle = initialize_ac_power_flow(system)
    arrays = compile_gs_arrays(system, device)
    rev = system.model.revision
    return AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState("gauss_seidel", factorization),
        arrays=arrays,
        device=device,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )


def gs_mismatch(analysis: AcPowerFlow):
    """Reference mismatch! for Gauss-Seidel."""
    vm, va = analysis._state()
    res = gs_sweep(analysis.arrays, *_to_rect(vm, va), max_sweeps=0)
    del_p, del_q = res.mismatch.tolist()
    analysis.method.max_mismatch_active = del_p
    analysis.method.max_mismatch_reactive = del_q
    return del_p, del_q


def gs_solve_step(analysis: AcPowerFlow):
    """Reference solve! for Gauss-Seidel: one sweep."""
    vm, va = analysis._state()
    res = gs_sweep(analysis.arrays, *_to_rect(vm, va), max_sweeps=1)
    vm, va = _to_polar(res.vre, res.vim)
    analysis.voltage.magnitude = vm.cpu().numpy()
    analysis.voltage.angle = va.cpu().numpy()
    analysis.method.iteration += 1
