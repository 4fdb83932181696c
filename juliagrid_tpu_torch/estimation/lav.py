"""LAV (least absolute value) state estimation on the in-house interior
point, on PyTorch tensors.

Port of ``juliagrid_tpu/estimation/lav.py``. The reference builds LAV as a
JuMP model with positive/negative deviation variables per measurement and
minimizes their sum, solved by Ipopt (acStateEstimation.jl:629-853 AC,
dcStateEstimation.jl:201-341 DC, pmuStateEstimation.jl:223-368 PMU). Here
the same model —

    min  Σ (u + v)   s.t.  h(x) + u - v = z,  u >= 0, v >= 0

— runs on ``opf/ipm.py``. The AC variant is a nonlinear program: h and its
Jacobian H come from K3 (``build_h``, one ``se_fill`` launch on the card),
and the Hessian −Σ yᵢ∇²hᵢ from ``torch.func.hessian`` over the torch
measurement functions of ``ops/equations.py`` (``weighted_h``), never
through K3's plain version. The DC and PMU variants are LPs whose
coefficient matrix is the estimator's dense H, scattered on the device from
its COO rows. In-service rows only (out-of-service devices drop out).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import hessian

from ..config import resolve_device
from ..kernels.se_fill import se_fill
from ..ops import equations as eq
from ..ops import linalg
from ..ops.equations import BRANCH_GROUPS
from ..opf.ipm import NlpProblem, solve_nlp
from ..powerflow.ac import Polar, compile_ac_arrays
from ..system.model import model
from .acse import AcStateEstimation, SeMethod, build_h, compile_se_arrays
from .dcse import (Angle, DcSeMethod, DcStateEstimation, compile_dcse_arrays)
from .pmuse import PmuSeMethod, PmuStateEstimation, compile_pmuse_arrays


def ac_lav_state_estimation(monitoring, device=None) -> AcStateEstimation:
    """Reference acLavStateEstimation (acStateEstimation.jl:629-853), on
    ``device`` (default ``config.device``)."""
    device = resolve_device(device)
    system = monitoring.system
    system.check_slack()
    model(system, "ac")
    n = system.bus.number
    arr, types, row_device = compile_se_arrays(system, monitoring,
                                               device=device)
    net = compile_ac_arrays(system, device)
    rev = system.model.revision
    method = SeMethod("lav", linalg.LU)
    method.type = types
    method.row_device = row_device
    return AcStateEstimation(
        system=system, monitoring=monitoring,
        voltage=Polar(system.bus.voltage.magnitude.array[:n].copy(),
                      system.bus.voltage.angle.array[:n].copy()),
        method=method, arrays=arr, net=net, device=device,
        signature={"ac_model": rev.ac_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values,
                   "slack": rev.slack},
    )


def lav_h(arr, net, state):
    """h(x) of every measurement row (status-masked) at states ``[...,
    2n]`` (θ then V): one K3 launch for all of them, no Jacobian."""
    n = state.shape[-1] // 2
    flat = state.reshape(-1, 2 * n)
    mean = arr.mean.expand(flat.shape[0], -1)
    h = se_fill(arr, net, flat[:, n:], flat[:, :n], mean,
                jacobian=False).h
    return h.reshape(state.shape[:-1] + (h.shape[-1],))


def weighted_h(arr, net, weight, state):
    """Σᵢ weightᵢ hᵢ(state) at the 2n state (θ then V) from the torch
    measurement functions of ``ops/equations.py``, out of place, so that
    ``torch.func`` can differentiate it (K3 computes the same hᵢ)."""
    n = state.shape[-1] // 2
    va, vm = state[:n], state[n:]
    w = weight * arr.status
    val = (w[arr.vm_rows] * vm[arr.vm_bus]).sum()
    val = val + (w[arr.va_rows] * va[arr.va_bus]).sum()
    val = val + (w[arr.rev_rows] * vm[arr.rev_bus]
                 * torch.cos(va[arr.rev_bus])).sum()
    val = val + (w[arr.imv_rows] * vm[arr.imv_bus]
                 * torch.sin(va[arr.imv_bus])).sum()
    for (ty, _, eval_fn), grp in zip(BRANCH_GROUPS, arr.branch):
        if grp.rows.shape[0] == 0:
            continue
        vi, vj = vm[grp.f], vm[grp.t]
        ti, tj = va[grp.f], va[grp.t]
        # branch rows at θij - φ, as K3 and h_entries evaluate them
        if ty in (15, 19, 21):
            ti = ti - grp.phi
        else:
            tj = tj + grp.phi
        hv = eval_fn(eq.PiCoeff(grp.a, grp.b, grp.c, grp.d), vi, vj, ti,
                     tj)[0]
        val = val + (w[grp.rows] * hv).sum()
    if arr.p_rows.shape[0] or arr.q_rows.shape[0]:
        rows, cols = net.rows.long(), net.cols.long()
        th_e = va[rows] - va[cols]
        st_e, ct_e = torch.sin(th_e), torch.cos(th_e)
        vv = vm[rows] * vm[cols]
        zeros = torch.zeros(n, dtype=w.dtype, device=w.device)
        # an injection row's h is the sum of its bus's entries: weight the
        # entries by their bus's row weight
        wp = zeros.index_add(0, arr.p_bus, w[arr.p_rows])
        wq = zeros.index_add(0, arr.q_bus, w[arr.q_rows])
        val = val + (wp[rows] * vv * (net.yg * ct_e + net.yb * st_e)).sum()
        val = val + (wq[rows] * vv * (net.yg * st_e - net.yb * ct_e)).sum()
    return val


def _ac_lav_fns(n: int, m_act: int):
    """AC LAV problem functions of ``(x, p)`` for ``n`` buses and ``m_act``
    active rows, with analytic derivatives: the equality Jacobian is [H(x),
    I, -I] (+ the slack-anchor row) with H from ``build_h``."""
    n_x = 2 * n + 2 * m_act

    def objective(xx, p):
        return xx[..., 2 * n:].sum(-1)

    def eq_fn(xx, p):
        state = xx[..., :2 * n]
        u = xx[..., 2 * n:2 * n + m_act]
        v = xx[..., 2 * n + m_act:]
        resid = lav_h(p["arr"], p["net"], state)[..., p["act"]] + u - v \
            - p["z"]
        anchor = state[..., p["slack"]] - p["anchor"]
        return torch.cat([resid, anchor[..., None]], -1)

    def ineq(xx, p):
        return xx[..., 2 * n:]

    def jac_eq(xx, p):
        H, _ = build_h(p["arr"], p["net"], xx[n:2 * n], xx[:n])
        J = xx.new_zeros((m_act + 1, n_x))
        J[:m_act, :2 * n] = H[p["act"]]
        rng = torch.arange(m_act, device=xx.device)
        J[rng, 2 * n + rng] = 1.0
        J[rng, 2 * n + m_act + rng] = -1.0
        J[m_act, p["slack"]] = 1.0
        return J

    def jac_ineq(xx, p):
        J = xx.new_zeros((2 * m_act, n_x))
        rng = torch.arange(2 * m_act, device=xx.device)
        J[rng, 2 * n + rng] = 1.0
        return J

    def hess(xx, y_raw, z_raw, p):
        # linear objective: ∇²L = -Σ yᵢ ∇²hᵢ(state), state block only
        weight = xx.new_zeros(p["arr"].mean.shape[0]).index_put(
            (p["act"],), y_raw[:m_act])
        hss = hessian(lambda state: -weighted_h(p["arr"], p["net"], weight,
                                                state))(xx[:2 * n])
        out = xx.new_zeros((n_x, n_x))
        out[:2 * n, :2 * n] = hss
        return out

    return objective, eq_fn, ineq, jac_eq, jac_ineq, hess


def lav_solve(analysis: AcStateEstimation, iteration: int = 200,
              power: bool = False, current: bool = False,
              tolerance: float = 1e-8):
    """Solve AC LAV via the IPM."""
    analysis._refresh_arrays()
    arr = analysis.arrays
    net = analysis.net
    dev = analysis.device
    n = analysis.system.bus.number
    active = np.flatnonzero(arr.status.cpu().numpy() == 1)
    m_act = len(active)
    act = torch.as_tensor(active, device=dev)
    z = arr.mean[act]
    slack = int(arr.slack)

    objective, eq_fn, ineq, jac_eq, jac_ineq, hess = _ac_lav_fns(n, m_act)
    pl = {"arr": arr, "net": net, "z": z, "act": act, "slack": slack,
          "anchor": float(analysis.voltage.angle[slack])}

    vm0 = np.asarray(analysis.voltage.magnitude, dtype=np.float64)
    va0 = np.asarray(analysis.voltage.angle, dtype=np.float64)
    _, h0 = build_h(arr, net, *analysis._state())
    r0 = (z - h0[act]).cpu().numpy()
    x0 = np.concatenate([va0, vm0, np.maximum(r0, 0) + 1e-3,
                         np.maximum(-r0, 0) + 1e-3])

    res = solve_nlp(NlpProblem(objective, eq_fn, ineq, jac_eq=jac_eq,
                               jac_ineq=jac_ineq, hess=hess, params=pl),
                    x0, max_iter=iteration, tol=tolerance, device=dev)
    analysis.voltage.angle = res.x[:n]
    analysis.voltage.magnitude = res.x[n:2 * n]
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    analysis.method.objective = res.objective
    if power:
        from ..postprocessing.ac import power as ac_power
        ac_power(analysis)
    if current:
        from ..postprocessing.ac import current as ac_current
        ac_current(analysis)
    return analysis


def dc_lav_state_estimation(monitoring, device=None) -> DcStateEstimation:
    """Reference dcLavStateEstimation (dcStateEstimation.jl:201-341), on
    ``device`` (default ``config.device``)."""
    device = resolve_device(device)
    system = monitoring.system
    system.check_slack()
    model(system, "dc")
    arr, row_device, inservice = compile_dcse_arrays(system, monitoring,
                                                     device=device)
    rev = system.model.revision
    method = DcSeMethod("dc_lav")
    method.row_device = row_device
    method.inservice = inservice
    return DcStateEstimation(
        system=system, monitoring=monitoring,
        voltage=Angle(np.zeros(system.bus.number)),
        method=method, arrays=arr, device=device,
        signature={"dc_model": rev.dc_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values,
                   "slack": rev.slack},
    )


def _lin_lav_problem(h, mean, slack=None):
    """The linear LAV (DC / PMU) problem on the dense H: its active rows
    (any nonzero coefficient), ``[h_act, I, -I]`` (+ the DC slack row when
    ``slack`` is given) as constant Jacobians, a zero Hessian."""
    active = torch.nonzero(h.abs().sum(1) > 0).flatten()
    h_act, z_act = h[active], mean[active]
    m_act, n_state = h_act.shape
    n_x = n_state + 2 * m_act
    extra = 0 if slack is None else 1
    je = h.new_zeros((m_act + extra, n_x))
    je[:m_act, :n_state] = h_act
    rng = torch.arange(m_act, device=h.device)
    je[rng, n_state + rng] = 1.0
    je[rng, n_state + m_act + rng] = -1.0
    if slack is not None:
        je[m_act, slack] = 1.0
    ji = h.new_zeros((2 * m_act, n_x))
    rng2 = torch.arange(2 * m_act, device=h.device)
    ji[rng2, n_state + rng2] = 1.0

    def objective(xx):
        return xx[..., n_state:].sum(-1)

    def eq_fn(xx):
        state = xx[..., :n_state]
        u = xx[..., n_state:n_state + m_act]
        v = xx[..., n_state + m_act:]
        resid = state @ h_act.mT + u - v - z_act
        if slack is not None:
            resid = torch.cat([resid, state[..., slack, None]], -1)
        return resid

    def ineq(xx):
        return xx[..., n_state:]

    problem = NlpProblem(objective, eq_fn, ineq, jac_eq=lambda xx: je,
                         jac_ineq=lambda xx: ji,
                         hess=lambda xx, yy, zz: xx.new_zeros((n_x, n_x)))
    return problem, m_act


def dc_lav_solve(analysis: DcStateEstimation, iteration: int = 200,
                 power: bool = False, tolerance: float = 1e-8):
    analysis._refresh_arrays()
    arr = analysis.arrays
    n = analysis.system.bus.number
    problem, m_act = _lin_lav_problem(arr.h_dense, arr.mean,
                                      slack=int(arr.slack))
    x0 = np.concatenate([np.zeros(n), np.ones(2 * m_act) * 0.1])
    res = solve_nlp(problem, x0, max_iter=iteration, tol=tolerance,
                    device=analysis.device)
    analysis.voltage.angle = res.x[:n] + float(arr.slack_angle)
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    if power:
        from ..postprocessing.dc import power as dc_power
        dc_power(analysis)
    return analysis


def pmu_lav_state_estimation(monitoring, device=None) -> PmuStateEstimation:
    """Reference pmuLavStateEstimation (pmuStateEstimation.jl:223-368), on
    ``device`` (default ``config.device``)."""
    device = resolve_device(device)
    system = monitoring.system
    model(system, "ac")
    arr, inservice = compile_pmuse_arrays(system, monitoring, device=device)
    rev = system.model.revision
    method = PmuSeMethod("pmu_lav")
    method.inservice = inservice
    n = system.bus.number
    return PmuStateEstimation(
        system=system, monitoring=monitoring,
        voltage=Polar(np.zeros(n), np.zeros(n)),
        method=method, arrays=arr, device=device,
        signature={"ac_model": rev.ac_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values},
    )


def pmu_lav_solve(analysis: PmuStateEstimation, iteration: int = 200,
                  power: bool = False, current: bool = False,
                  tolerance: float = 1e-8):
    analysis._refresh_arrays()
    arr = analysis.arrays
    n = analysis.system.bus.number
    problem, m_act = _lin_lav_problem(arr.h_dense, arr.mean)
    x0 = np.concatenate([np.ones(n), np.zeros(n), 0.1 * np.ones(2 * m_act)])
    res = solve_nlp(problem, x0, max_iter=iteration, tol=tolerance,
                    device=analysis.device)
    re, im = res.x[:n], res.x[n:2 * n]
    analysis.voltage.magnitude = np.hypot(re, im)
    analysis.voltage.angle = np.arctan2(im, re)
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    if power:
        from ..postprocessing.ac import power as ac_power
        ac_power(analysis)
    if current:
        from ..postprocessing.ac import current as ac_current
        ac_current(analysis)
    return analysis
