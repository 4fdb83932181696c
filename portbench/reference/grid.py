"""Plain PyTorch Newton-Raphson power flow and Gauss-Newton WLS state
estimation over a batch of scenarios, for the benchmark's comparison.

Dense complex matrices throughout (MATPOWER's ``dSbus_dV`` for the
injections, each branch end's four partials by hand), ``torch.linalg`` for
the solves, in the precision that ``dtype`` gives (float64 for the
reference, float32 for the control). Imports nothing of the program under
test. The loops keep the iteration rules of JuliaGrid's drivers, which the
program's fleets keep too:

- NR: stop a scenario once max|dP| over the non-slack buses and max|dQ|
  over the PQ buses are both below ``tol``; the count is the number of
  Newton steps taken;
- GN: stop a scenario once the max|dx| of its next increment is below
  ``tol``; the count is the number of increments applied; the slack's
  angle is held (its column left out of the normal equations); a
  scenario whose normal equations leave a relative residual above 1e-6 is
  not converged.

Scenarios iterate together; a stopped scenario keeps its state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .case import Case

#: the program's escalation gate on ||rhs - G dx|| / ||rhs|| (JuliaGrid's
#: refinement test), which a converged scenario must meet
REL_GATE = 1e-6


def _complex(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


@dataclass
class Grid:
    """A case's network as tensors on one device, in one precision."""

    case: Case
    y: torch.Tensor          # [n, n] complex
    f: torch.Tensor
    t: torch.Tensor
    yff: torch.Tensor
    yft: torch.Tensor
    ytf: torch.Tensor
    ytt: torch.Tensor
    dtype: torch.dtype

    @classmethod
    def build(cls, case: Case, device, dtype=torch.float64) -> "Grid":
        cdt = _complex(dtype)

        def c(a):
            return torch.as_tensor(a, device=device).to(cdt)

        return cls(case=case, y=c(case.ybus()),
                   f=torch.as_tensor(case.f, device=device),
                   t=torch.as_tensor(case.t, device=device),
                   yff=c(case.yff), yft=c(case.yft), ytf=c(case.ytf),
                   ytt=c(case.ytt), dtype=dtype)

    def voltage(self, vm, va):
        return torch.polar(vm.to(self.dtype), va.to(self.dtype))

    def injections(self, v):
        """Complex bus injections ``[B, n]`` and the currents."""
        cur = v @ self.y.T
        return v * cur.conj(), cur

    def ds_dv(self, v, cur):
        """dS/dVa and dS/dVm ``[B, n, n]`` (MATPOWER's dSbus_dV)."""
        vn = v / v.abs()
        yv = self.y[None] * v[:, None, :]
        ds_dva = 1j * v[:, :, None] * (torch.diag_embed(cur) - yv).conj()
        ds_dvm = v[:, :, None] * (self.y[None] * vn[:, None, :]).conj() \
            + torch.diag_embed(cur.conj() * vn)
        return ds_dva, ds_dvm


# --------------------------------------------------------------------------
# Newton-Raphson
# --------------------------------------------------------------------------

def _nr_mismatch(grid: Grid, vm, va, p, q, pvpq, pq):
    s, cur = grid.injections(grid.voltage(vm, va))
    dp = (s.real - p)[:, pvpq]
    dq = (s.imag - q)[:, pq]
    return s, cur, dp, dq


def nr_solve(grid: Grid, vm0, va0, p_sched, q_sched, tol=1e-8,
             max_iter=20, chunk=None):
    """Newton-Raphson from ``vm0, va0`` for the scheduled injections
    ``p_sched, q_sched`` (all ``[B, n]``). Returns ``(vm, va, iterations,
    converged)`` as the program's ``batched_nr_solve`` does; ``chunk``
    bounds the scenarios held at once."""
    if chunk is not None and vm0.shape[0] > chunk:
        parts = [nr_solve(grid, *(x[i:i + chunk] for x in (vm0, va0, p_sched,
                                                          q_sched)),
                          tol=tol, max_iter=max_iter)
                 for i in range(0, vm0.shape[0], chunk)]
        return tuple(torch.cat(z) for z in zip(*parts))
    case, dt = grid.case, grid.dtype
    dev = vm0.device
    pvpq = torch.as_tensor(np.flatnonzero(case.bus_type != 3), device=dev)
    pq = torch.as_tensor(np.flatnonzero(case.bus_type == 1), device=dev)
    vm, va = vm0.to(dt).clone(), va0.to(dt).clone()
    p, q = p_sched.to(dt), q_sched.to(dt)

    def done(dp, dq):
        return (dp.abs().amax(-1) < tol) & (dq.abs().amax(-1) < tol)

    _, cur, dp, dq = _nr_mismatch(grid, vm, va, p, q, pvpq, pq)
    active = ~done(dp, dq)
    iters = torch.zeros(vm.shape[0], dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter and bool(active.any()):
        idx = active.nonzero()[:, 0]
        v = grid.voltage(vm[idx], va[idx])
        ds_dva, ds_dvm = grid.ds_dv(v, cur[idx])
        jac = torch.cat([
            torch.cat([ds_dva.real[:, pvpq][:, :, pvpq],
                       ds_dvm.real[:, pvpq][:, :, pq]], 2),
            torch.cat([ds_dva.imag[:, pq][:, :, pvpq],
                       ds_dvm.imag[:, pq][:, :, pq]], 2)], 1)
        rhs = torch.cat([dp[idx], dq[idx]], 1)
        dx = torch.linalg.solve(jac, -rhs)
        k = pvpq.numel()
        va[idx[:, None], pvpq[None]] += dx[:, :k]
        vm[idx[:, None], pq[None]] += dx[:, k:]
        iters[idx] += 1
        _, cur, dp, dq = _nr_mismatch(grid, vm, va, p, q, pvpq, pq)
        active &= ~done(dp, dq)
        it += 1
    return vm, va, iters, ~active


# --------------------------------------------------------------------------
# The measurement set and WLS state estimation
# --------------------------------------------------------------------------

@dataclass
class MeasurementSet:
    """Rows in the program's device order: voltmeters, wattmeters,
    varmeters, PMUs (a magnitude and an angle row each). A watt- or
    varmeter set is every bus's injection, then each in-service branch's
    from and to end."""

    volt_bus: np.ndarray
    pmu_bus: np.ndarray
    variance: np.ndarray     # [m], per row

    @classmethod
    def every_bus_and_branch(cls, case: Case, pmu_every: int,
                             variances: dict) -> "MeasurementSet":
        n, nb = case.n, len(case.f)
        volt = np.arange(n)
        pmu = np.arange(0, n, pmu_every)
        var = np.concatenate([
            np.full(n, variances["voltmeter"]),
            np.full(n + 2 * nb, variances["wattmeter"]),
            np.full(n + 2 * nb, variances["varmeter"]),
            np.tile([variances["pmu_magnitude"], variances["pmu_angle"]],
                    len(pmu))])
        return cls(volt_bus=volt, pmu_bus=pmu, variance=var)

    @property
    def rows(self) -> int:
        return self.variance.shape[0]


def _flows(grid: Grid, v):
    vf, vt = v[:, grid.f], v[:, grid.t]
    sf = vf * (grid.yff * vf + grid.yft * vt).conj()
    st = vt * (grid.ytf * vf + grid.ytt * vt).conj()
    return sf, st


def _interleave(a, b):
    """``[B, k]`` and ``[B, k]`` as ``[B, 2k]``: a0, b0, a1, b1, ..."""
    return torch.stack([a, b], -1).reshape(a.shape[0], -1)


def measure(grid: Grid, meas: MeasurementSet, vm, va):
    """h(x) ``[B, m]`` in the set's row order."""
    v = grid.voltage(vm, va)
    s, _ = grid.injections(v)
    sf, st = _flows(grid, v)
    pmu = torch.as_tensor(meas.pmu_bus, device=vm.device)
    return torch.cat([
        vm.to(grid.dtype)[:, meas.volt_bus],
        s.real, _interleave(sf.real, st.real),
        s.imag, _interleave(sf.imag, st.imag),
        _interleave(vm.to(grid.dtype)[:, pmu], va.to(grid.dtype)[:, pmu])],
        1)


def _branch_partials(grid: Grid, v, vm):
    """Each branch end's complex flow's partials by (va_f, va_t, vm_f,
    vm_t): ``[B, nb, 4]`` for the from and the to end."""
    vf, vt = v[:, grid.f], v[:, grid.t]
    mf, mt = vm[:, grid.f], vm[:, grid.t]
    # Sf = |Vf|² conj(yff) + conj(yft) Vf conj(Vt)
    cross_f = grid.yft.conj() * vf * vt.conj()
    d_f = torch.stack([1j * cross_f, -1j * cross_f,
                       2 * mf * grid.yff.conj() + cross_f / mf,
                       cross_f / mt], -1)
    cross_t = grid.ytf.conj() * vt * vf.conj()
    d_t = torch.stack([-1j * cross_t, 1j * cross_t, cross_t / mf,
                       2 * mt * grid.ytt.conj() + cross_t / mt], -1)
    return d_f, d_t


def jacobian(grid: Grid, meas: MeasurementSet, vm, va):
    """H ``[B, m, 2n]``, columns the angles then the magnitudes."""
    n, nb = grid.case.n, grid.f.numel()
    bsz, dev = vm.shape[0], vm.device
    vm = vm.to(grid.dtype)
    v = grid.voltage(vm, va)
    _, cur = grid.injections(v)
    ds_dva, ds_dvm = grid.ds_dv(v, cur)
    d_f, d_t = _branch_partials(grid, v, vm)
    h = torch.zeros((bsz, meas.rows, 2 * n), dtype=grid.dtype, device=dev)
    row = 0
    h[:, torch.arange(n, device=dev), n + torch.as_tensor(
        meas.volt_bus, device=dev)] = 1.0
    row += len(meas.volt_bus)
    cols = torch.stack([grid.f, grid.t, n + grid.f, n + grid.t], -1)
    for part in ("real", "imag"):
        h[:, row:row + n, :n] = getattr(ds_dva, part)
        h[:, row:row + n, n:] = getattr(ds_dvm, part)
        row += n
        rows_f = row + 2 * torch.arange(nb, device=dev)[:, None]
        h[:, rows_f, cols] = getattr(d_f, part)
        h[:, rows_f + 1, cols] = getattr(d_t, part)
        row += 2 * nb
    pmu = torch.as_tensor(meas.pmu_bus, device=dev)
    rows_m = row + 2 * torch.arange(pmu.numel(), device=dev)
    h[:, rows_m, n + pmu] = 1.0
    h[:, rows_m + 1, pmu] = 1.0
    return h


def se_solve(grid: Grid, meas: MeasurementSet, vm0, va0, means, tol=1e-8,
             max_iter=40, chunk=None):
    """Gauss-Newton WLS from ``vm0, va0`` (``[B, n]``) for the row means
    ``means`` (``[B, m]``). Returns ``(vm, va, iterations, converged)`` as
    the program's ``batched_se_solve`` does."""
    if chunk is not None and vm0.shape[0] > chunk:
        parts = [se_solve(grid, meas, *(x[i:i + chunk]
                                        for x in (vm0, va0, means)),
                          tol=tol, max_iter=max_iter)
                 for i in range(0, vm0.shape[0], chunk)]
        return tuple(torch.cat(z) for z in zip(*parts))
    n, dt, dev = grid.case.n, grid.dtype, vm0.device
    w = torch.as_tensor(1.0 / meas.variance, device=dev).to(dt)
    keep = torch.as_tensor(np.flatnonzero(np.arange(2 * n) != grid.case.slack),
                           device=dev)
    vm, va = vm0.to(dt).clone(), va0.to(dt).clone()
    means = means.to(dt)

    def increment(idx):
        h = jacobian(grid, meas, vm[idx], va[idx])[:, :, keep]
        r = means[idx] - measure(grid, meas, vm[idx], va[idx])
        wh = h * w[None, :, None]
        gain = h.mT @ wh
        rhs = (wh.mT @ r[..., None])[..., 0]
        chol, info = torch.linalg.cholesky_ex(gain)
        dxk = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        rel = (rhs - (gain @ dxk[..., None])[..., 0]).norm(dim=-1) / \
            rhs.norm(dim=-1)
        rel = torch.where(info != 0, torch.inf, rel)
        dx = torch.zeros((idx.numel(), 2 * n), dtype=dt, device=dev)
        dx[:, keep] = dxk
        return dx, dx.abs().amax(-1), rel

    every = torch.arange(vm.shape[0], device=dev)
    dx, maxinc, relmax = increment(every)
    active = maxinc >= tol
    iters = torch.zeros(vm.shape[0], dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter and bool(active.any()):
        idx = active.nonzero()[:, 0]
        va[idx] += dx[idx, :n]
        vm[idx] += dx[idx, n:]
        iters[idx] += 1
        dx_a, maxinc_a, rel_a = increment(idx)
        dx[idx] = dx_a
        relmax[idx] = torch.maximum(relmax[idx], rel_a)
        active[idx] = maxinc_a >= tol
        it += 1
    return vm, va, iters, ~active & (relmax <= REL_GATE)
