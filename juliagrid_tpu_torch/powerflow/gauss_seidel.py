"""Gauss-Seidel AC power flow on PyTorch tensors.

Port of ``juliagrid_tpu/powerflow/gauss_seidel.py`` (after JuliaGrid
src/powerFlow/acPowerFlow.jl:563-619 for the set-up, :732-764 for the
mismatch on PQ/PV buses and :985-1041 for the sequential sweep: PQ update,
PV update with the computed reactive injection, PV magnitude reprojection).

The per-bus sweep is sequential. Each iteration is one launch of the
hand-written CUDA kernel K4 (``kernels/gs_sweep.py``), which runs the whole
sweep over a padded per-bus neighbour table in one thread block and returns
the mismatch maxima at the new state, and one readback of that pair.
Complex arithmetic is carried as explicit (re, im) f64 pairs.
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


def compile_gs_arrays(system: PowerSystem, device=None) -> GsArrays:
    """``GsArrays`` on ``device``: the padded neighbour table of the sorted
    Y-bus entry list (each row's entries in column order, zero-padded to the
    widest row) and the per-bus values, built on the host."""
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
    """Full Gauss-Seidel loop: one K4 launch (the sweep and the mismatch at
    its result) and one scalar-pair readback per iteration, after one launch
    for the mismatch at the start. ``sweep`` exists so a check can run the
    same loop on ``gs_sweep_ref``; the main path never passes it."""
    res = sweep(arr, *_to_rect(vm, va), sweep=False)
    it = 0
    while True:
        del_p, del_q = res.mismatch.tolist()
        converged = del_p < tol and del_q < tol
        if converged or it >= max_iter:
            break
        res = sweep(arr, res.vre, res.vim, sweep=True)
        it += 1
    return (*_to_polar(res.vre, res.vim), it, del_p, del_q, converged)


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
    res = gs_sweep(analysis.arrays, *_to_rect(vm, va), sweep=False)
    del_p, del_q = res.mismatch.tolist()
    analysis.method.max_mismatch_active = del_p
    analysis.method.max_mismatch_reactive = del_q
    return del_p, del_q


def gs_solve_step(analysis: AcPowerFlow):
    """Reference solve! for Gauss-Seidel: one sweep."""
    vm, va = analysis._state()
    res = gs_sweep(analysis.arrays, *_to_rect(vm, va))
    vm, va = _to_polar(res.vre, res.vim)
    analysis.voltage.magnitude = vm.cpu().numpy()
    analysis.voltage.angle = va.cpu().numpy()
    analysis.method.iteration += 1
