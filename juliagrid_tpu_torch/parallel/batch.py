"""Scenario batching: Newton-Raphson over a fleet of scenarios on one card.

The reference runs scenario studies by re-running scripts. Here the scenario
axis is a leading tensor dimension: K1 runs with scenarios on its launch
grid (one warp per scenario and bus), and the Jacobians factor in one
batched f64 ``torch.linalg.lu_factor``/``lu_solve``.
"""

from __future__ import annotations

import torch

from ..kernels.nr_fill import nr_fill
from ..powerflow.ac import AcArrays, _max_mismatch, _nr_update


def batched_nr_solve(arr: AcArrays, vm0, va0, p_sched, q_sched,
                     tol: float = 1e-8, max_iter: int = 20, fill=nr_fill):
    """Batched Newton-Raphson over scenarios.

    ``vm0, va0, p_sched, q_sched`` are ``[B, n]``; the network (Y-bus
    pattern/values) is shared. All scenarios iterate in lockstep until every
    scenario converges or hits the cap; only scenarios still active advance,
    each with its own iteration count — the batched equivalent of the
    reference driver loop. Returns (vm, va, iterations, converged).
    ``fill`` exists so a check can run the same loop on ``nr_fill_ref``;
    the main path never passes it.
    """
    vm, va = vm0, va0
    res = fill(arr, vm, va, p_sched, q_sched, jacobian=True)
    dpq = _max_mismatch(res)
    active = ~((dpq[:, 0] < tol) & (dpq[:, 1] < tol))
    iters = torch.zeros(vm.shape[0], dtype=torch.int32, device=vm.device)
    it = 0
    while it < max_iter and bool(active.any()):
        vm_new, va_new = _nr_update(arr, vm, va, res, "LU")
        vm = torch.where(active[:, None], vm_new, vm)
        va = torch.where(active[:, None], va_new, va)
        iters += active.to(iters.dtype)
        res = fill(arr, vm, va, p_sched, q_sched, jacobian=True)
        dpq = _max_mismatch(res)
        active &= ~((dpq[:, 0] < tol) & (dpq[:, 1] < tol))
        it += 1
    return vm, va, iters, ~active
