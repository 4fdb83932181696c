"""Scenario batching: Newton-Raphson, DC power flow and WLS state
estimation over a fleet of scenarios on one card.

The reference runs scenario studies by re-running scripts. Here the scenario
axis is a leading tensor dimension: K1 and K3 run with scenarios on their
launch grids (one warp per scenario and bus, or scenario and measurement
row), the NR Jacobians factor in one batched f64
``torch.linalg.lu_factor_ex``/``lu_solve``, the SE gains form in one
batched matmul and factor in one batched f64 Cholesky, and the DC fleet
shares one factorization of B and solves every scenario in one call.
"""

from __future__ import annotations

import torch

from ..estimation.acse import SeArrays, _normal_increment
from ..kernels.nr_fill import nr_fill
from ..ops import linalg
from ..kernels.se_fill import se_fill
from ..powerflow.ac import AcArrays, _max_mismatch, _nr_update
from ..powerflow.dc import DcArrays, _masked_b


def batched_nr_solve(arr: AcArrays, vm0, va0, p_sched, q_sched,
                     tol: float = 1e-8, max_iter: int = 20, fill=nr_fill):
    """Batched Newton-Raphson over scenarios.

    ``vm0, va0, p_sched, q_sched`` are ``[B, n]``; the network (Y-bus
    pattern/values) is shared. All scenarios iterate in lockstep until every
    scenario converges or hits the cap; only scenarios still active advance,
    each with its own iteration count — the batched equivalent of the
    reference's iteration loop. Returns (vm, va, iterations, converged). A
    scenario whose Jacobian is singular does not stop the fleet: its state
    turns to inf or NaN, which never converges, and it runs to the cap as
    in the JAX package.
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
        vm_new, va_new = _nr_update(arr, vm, va, res, "LU", check=False)
        vm = torch.where(active[:, None], vm_new, vm)
        va = torch.where(active[:, None], va_new, va)
        iters += active.to(iters.dtype)
        res = fill(arr, vm, va, p_sched, q_sched, jacobian=True)
        dpq = _max_mismatch(res)
        active &= ~((dpq[:, 0] < tol) & (dpq[:, 1] < tol))
        it += 1
    return vm, va, iters, ~active


def batched_se_solve(arr: SeArrays, net: AcArrays, vm0, va0, means,
                     tol: float = 1e-8, max_iter: int = 40, fill=se_fill):
    """Batched Gauss-Newton WLS over scenario measurement means.

    ``means`` is ``[B, m]`` and ``vm0, va0`` are ``[B, n]``; the measurement
    pattern, weights and network are shared. All scenarios iterate in
    lockstep (one K3 launch, one batched gain and Cholesky, and one
    readback per iteration) until every scenario's max|dx| is below ``tol``
    or the cap is hit; only scenarios still active advance, each with its
    own count. Returns (vm, va, iterations, converged), where a scenario
    whose normal equations were not solved to a relative residual of 1e-6
    (``rel``, the escalation gate of ``state_estimation``) counts as not
    converged. ``fill`` exists so a check can run the same loop on
    ``se_fill_ref``; the main path never passes it.
    """
    n = vm0.shape[1]
    vm, va = vm0, va0
    dx, maxinc, relmax = _normal_increment(arr, net, vm, va, means, fill)
    active = maxinc >= tol
    iters = torch.zeros(vm.shape[0], dtype=torch.int32, device=vm.device)
    it = 0
    while it < max_iter and bool(active.any()):
        va = torch.where(active[:, None], va + dx[:, :n], va)
        vm = torch.where(active[:, None], vm + dx[:, n:], vm)
        iters += active.to(iters.dtype)
        dx, maxinc, rel = _normal_increment(arr, net, vm, va, means, fill)
        relmax = torch.where(active, torch.maximum(relmax, rel), relmax)
        active &= maxinc >= tol
        it += 1
    return vm, va, iters, ~active & (relmax <= 1e-6)


def batched_dc_solve(arr: DcArrays, p_sched, method: str = "LU"):
    """Batched DC power flow over injection scenarios.

    ``p_sched`` is ``[B, n]`` scheduled injections. The shared slack-masked
    B factors once (``method``, as ``powerflow.dc._dc_solve`` takes it) and
    every scenario is solved in one call, with the scenarios as the columns
    of the right-hand side — the amortization the constant DC matrix exists
    for (the reference re-factorizes per run, dcPowerFlow.jl:165-193).
    Returns ``[B, n]`` bus angles."""
    b, m = _masked_b(arr)
    fac = linalg.factorize(b, method)
    rhs = (p_sched - arr.shift[None, :] - arr.gshunt[None, :]) * m[None, :]
    theta = linalg.solve_columns(fac, rhs.mT)
    return theta.mT + arr.slack_angle
