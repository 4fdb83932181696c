"""Scenario batching: Newton-Raphson, DC power flow and WLS state
estimation over a fleet of scenarios, on one device or sharded over a mesh.

The reference runs scenario studies by re-running scripts. Here the scenario
axis is a leading tensor dimension: K1 and K3 run with scenarios on their
launch grids (one warp per scenario and bus, or scenario and measurement
row), every scenario's NR Jacobian, at the unknowns' order npv + 2·npq, is
factored and solved in one launch of K2 (``kernels/fleet_solve.py``: f64 LU
with partial pivoting, a thread block a scenario), the SE gains form in one
K8 launch from H's entry pattern (``kernels/gain_fill.py``) and are solved
in one K2 launch in its Cholesky mode, and the DC fleet shares one
factorization of B and solves every scenario in one call. ``fleet_solve``
decides both solves' route: K2 up to its order cap of 256, the batched
library calls above it.

Across ranks (``sharded_nr_solve``, ``sharded_se_solve`` over a
``parallel/mesh.py`` mesh) each rank takes its contiguous share of the
scenarios and runs the same loop on it; the loop's "any scenario active"
test is an all-reduce (max) over the ranks, the JAX program's global
``while_loop`` condition, so every rank runs the same number of trips, and
the results come back whole on every rank, as a JAX global array does.

Each fleet call is a profiler range, ``jgt.nr_fleet`` or ``jgt.se_fleet``,
split into stages by ``utils.profiling.mark``: in trip order, NR
``fill`` (K1 with its Jacobian's memset, the mismatch maxima and the
convergence mask), ``test`` (the "any scenario active" readback, or the
mesh's all-reduce, marked ``all-reduce`` within it) and ``solve`` (the
right-hand side's gather, K2 or the library's LU, the step at the unknowns,
the counts); SE ``fill`` (K3's
entry mode), ``gain`` (K8's table lookup and launch), ``solve`` (K2 or
the library's Cholesky, the residual and the increment's maximum: these
three marked in ``estimation.acse._normal_increment``), ``test`` (the
convergence flags and the readback) and ``update`` (the state adds, the
counts). A call makes one more ``test`` than its largest count. The marks
cost a few flag tests a stage while neither a profiler nor a
``utils.profiling.device_stages`` block records.
"""

from __future__ import annotations

import torch

from ..estimation.acse import SeArrays, _normal_increment
from ..kernels.nr_fill import nr_fill
from ..ops import linalg
from ..kernels.gain_fill import gain_fill
from ..kernels.se_fill import se_fill_entries
from ..powerflow.ac import AcArrays, _max_mismatch, _nr_update
from ..powerflow.dc import DcArrays, _masked_b
from ..utils.profiling import annotate, mark
from .mesh import Mesh


def _local_any(active) -> bool:
    return bool(active.any())


def batched_nr_solve(arr: AcArrays, vm0, va0, p_sched, q_sched,
                     tol: float = 1e-8, max_iter: int = 20, fill=nr_fill,
                     any_active=_local_any):
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
    the main path never passes it. ``any_active`` decides whether the loop
    goes on (over the ranks of a mesh in ``sharded_nr_solve``).
    """
    with annotate("jgt.nr_fleet"):
        try:
            mark("fill")
            vm, va = vm0, va0
            res = fill(arr, vm, va, p_sched, q_sched, jacobian=True)
            dpq = _max_mismatch(res)
            active = ~((dpq[:, 0] < tol) & (dpq[:, 1] < tol))
            iters = torch.zeros(vm.shape[0], dtype=torch.int32,
                                device=vm.device)
            it = 0
            mark("test")
            while it < max_iter and any_active(active):
                mark("solve")
                vm_new, va_new = _nr_update(arr, vm, va, res, "LU",
                                            check=False)
                vm = torch.where(active[:, None], vm_new, vm)
                va = torch.where(active[:, None], va_new, va)
                iters += active.to(iters.dtype)
                mark("fill")
                res = fill(arr, vm, va, p_sched, q_sched, jacobian=True)
                dpq = _max_mismatch(res)
                active &= ~((dpq[:, 0] < tol) & (dpq[:, 1] < tol))
                it += 1
                mark("test")
            return vm, va, iters, ~active
        finally:
            mark(None)


def batched_se_solve(arr: SeArrays, net: AcArrays, vm0, va0, means,
                     tol: float = 1e-8, max_iter: int = 40,
                     fill=se_fill_entries, gain=gain_fill,
                     any_active=_local_any):
    """Batched Gauss-Newton WLS over scenario measurement means.

    ``means`` is ``[B, m]`` and ``vm0, va0`` are ``[B, n]``; the measurement
    pattern, weights and network are shared. All scenarios iterate in
    lockstep (one launch of K3's entry mode, one of K8 for the gains, one
    K2 Cholesky solve and one readback per iteration) until every scenario's max|dx| is below ``tol``
    or the cap is hit; only scenarios still active advance, each with its
    own count. Returns (vm, va, iterations, converged), where a scenario
    whose normal equations were not solved to a relative residual of 1e-6
    (``rel``, the escalation gate of ``state_estimation``) counts as not
    converged. ``fill`` and ``gain`` exist so a check can run the same loop
    on ``se_fill_entries_ref`` and ``gain_fill_ref``; the main path never
    passes them. ``any_active`` as in
    ``batched_nr_solve``.
    """
    n = vm0.shape[1]
    with annotate("jgt.se_fleet"):
        try:
            vm, va = vm0, va0
            dx, maxinc, relmax = _normal_increment(arr, net, vm, va, means,
                                                   fill, gain)
            mark("test")
            active = maxinc >= tol
            iters = torch.zeros(vm.shape[0], dtype=torch.int32,
                                device=vm.device)
            it = 0
            while it < max_iter and any_active(active):
                mark("update")
                va = torch.where(active[:, None], va + dx[:, :n], va)
                vm = torch.where(active[:, None], vm + dx[:, n:], vm)
                iters += active.to(iters.dtype)
                dx, maxinc, rel = _normal_increment(arr, net, vm, va, means,
                                                    fill, gain)
                mark("test")
                relmax = torch.where(active, torch.maximum(relmax, rel),
                                     relmax)
                active &= maxinc >= tol
                it += 1
            return vm, va, iters, ~active & (relmax <= 1e-6)
        finally:
            mark(None)


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


def _on(tree, device):
    """``tree`` (a tensor, or NamedTuples and tuples of them and of plain
    fields) on ``device``; a tensor already there is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        items = [_on(f, device) for f in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return tree


def shard_scenarios(mesh: Mesh, *arrays, axis: str = "scenario"):
    """This rank's contiguous share of each scenario-batched array (leading
    axis), on the mesh's device: the port's ``NamedSharding(mesh,
    P(axis))``. The leading axis must divide by the axis size."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has axes {mesh.axis_names}, not {axis!r}")
    return tuple(torch.as_tensor(a)[mesh.rows(a.shape[0])].to(mesh.device)
                 for a in arrays)


def _gather_rows(mesh: Mesh, nscen: int, parts):
    """The whole ``[nscen, ...]`` results on every rank from each rank's
    share: one all-reduce (sum) of a zero buffer holding this rank's rows
    (each element is its owner's value plus zeros, so exact), packed as
    f64 columns and split back into ``parts``' shapes and dtypes."""
    rows = mesh.rows(nscen)
    flat = [p.reshape(p.shape[0], -1) for p in parts]
    widths = [f.shape[1] for f in flat]
    buf = torch.zeros((nscen, sum(widths)), dtype=torch.float64,
                      device=mesh.device)
    buf[rows] = torch.cat([f.to(torch.float64) for f in flat], dim=1)
    mesh.all_reduce(buf)
    out = []
    for p, piece in zip(parts, buf.split(widths, dim=1)):
        out.append(piece.reshape((nscen,) + p.shape[1:]).to(p.dtype))
    return tuple(out)


def sharded_nr_solve(mesh: Mesh, arr: AcArrays, vm0, va0, p_sched, q_sched,
                     tol: float = 1e-8, max_iter: int = 20):
    """Scenario-sharded batched NR over ``mesh``: called by every rank with
    the whole, replicated inputs. Each rank solves its share with
    ``batched_nr_solve`` (K1 on its slice), the loop going on while a
    scenario of any rank is active; returns the whole ``(vm, va,
    iterations, converged)`` on every rank."""
    nscen = vm0.shape[0]
    vm, va, ps, qs = shard_scenarios(mesh, vm0, va0, p_sched, q_sched)
    out = batched_nr_solve(_on(arr, mesh.device), vm, va, ps, qs, tol=tol,
                           max_iter=max_iter, any_active=mesh.any)
    try:
        return _gather_rows(mesh, nscen, out)
    finally:
        mark(None)  # the gather's all-reduce stage


def sharded_se_solve(mesh: Mesh, arr: SeArrays, net: AcArrays, vm0, va0,
                     means, tol: float = 1e-8, max_iter: int = 40):
    """Scenario-sharded batched WLS SE over ``mesh``, as
    ``sharded_nr_solve`` (K3's entry mode and K8 on each rank's
    slice)."""
    nscen = vm0.shape[0]
    vm, va, mean = shard_scenarios(mesh, vm0, va0, means)
    out = batched_se_solve(_on(arr, mesh.device), _on(net, mesh.device), vm,
                           va, mean, tol=tol, max_iter=max_iter,
                           any_active=mesh.any)
    try:
        return _gather_rows(mesh, nscen, out)
    finally:
        mark(None)  # the gather's all-reduce stage
