"""Fast Newton-Raphson (fast decoupled) power flow, BX and XB variants, on
PyTorch tensors.

Port of ``juliagrid_tpu/powerflow/fast_decoupled.py`` (after JuliaGrid
src/powerFlow/acPowerFlow.jl:215-483 for the constant B'/B'' Jacobians,
:698-730 for the V-scaled mismatches and :913-983 for the half-iteration
scheme: P-solve, angle update, fresh Q mismatch, Q-solve).

B' and B'' are constant: they are assembled on the analysis device from
their COO coefficients, masked to full n x n (identity on the slack row and
on non-PQ rows) and factored once in f64 with ``torch.linalg.lu_factor`` at
construction and on a refresh. An iteration is two ``lu_solve`` calls and
two launches of K1 (``kernels/nr_fill.py``) without the Jacobian for the
injections. The JAX package's f32 factor with three f64 refinement sweeps
is not ported: the card factors in f64.

The BBD variant (``fast_newton_raphson_bbd``, the large-network form)
builds B' and B'' as scipy CSR on the host, cuts them into bordered
block-diagonal form on the ``nd_partition`` of the Y-bus pattern, and
factors them once in f64 (``ops/bbd.py::bbd_precompute``); its half-steps
are ``bbd_presolved_solve`` calls, its mismatches K1 without the Jacobian.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_device
from ..kernels.nr_fill import nr_fill
from ..ops import linalg
from ..ops.bbd import bbd_precompute, bbd_presolved_solve, build_bbd_arrays
from ..ops.partition import nd_partition
from ..system.model import model
from ..system.types import PowerSystem
from .ac import (AcPowerFlow, MethodState, Polar, compile_ac_arrays,
                 initialize_ac_power_flow)


class FnrArrays(NamedTuple):
    """The ``AcArrays`` fields K1 reads, and the f64 LU factors and pivots
    of the masked B' and B''."""

    rows: torch.Tensor
    cols: torch.Tensor
    yg: torch.Tensor
    yb: torch.Tensor
    diag: torch.Tensor
    bus_type: torch.Tensor
    slack: int
    p_sched: torch.Tensor
    q_sched: torch.Tensor
    row_ptr: torch.Tensor
    bp: linalg.DenseFactor  # LU of the masked B' (f64[n, n], i32[n] pivots)
    bq: linalg.DenseFactor  # LU of the masked B''


def _fnr_coefficients(system: PowerSystem, bx: bool):
    """COO coefficients of B' and B'' (reference fastNewtonJacobian!/
    jacobianCoefficient, acPowerFlow.jl:416-483): the entry positions
    ``(rows, cols)``, shared by both, and the values of each, in the order
    in which ``juliagrid_tpu``'s ``_fnr_matrices`` adds them up."""
    m = system.branch.number
    prm = system.branch.parameter
    f = system.branch.layout.from_bus.array[:m]
    t = system.branch.layout.to_bus.array[:m]
    on = system.branch.layout.status.array[:m] == 1

    r = prm.resistance.array[:m]
    x = prm.reactance.array[:m]
    bsi = 0.5 * prm.susceptance.array[:m]
    tau_inv = 1.0 / prm.turns_ratio.array[:m]
    phi = prm.shift_angle.array[:m]
    sin_p, cos_p = np.sin(phi), np.cos(phi)

    y = np.where(on, 1.0 / (r + 1j * x), 0.0)
    if bx:
        bmk = np.where(on, -1.0 / x, 0.0)
        p_a, p_b = y.real, y.imag
    else:
        bmk = y.imag
        p_a = np.zeros(m)
        p_b = np.where(on, -1.0 / x, 0.0)

    denom = cos_p**2 + sin_p**2
    pij = np.where(on, (-p_a * sin_p - p_b * cos_p) / denom, 0.0)
    pji = np.where(on, (p_a * sin_p - p_b * cos_p) / denom, 0.0)
    pii = np.where(on, p_b / denom, 0.0)
    pjj = np.where(on, p_b, 0.0)

    q_a = np.where(on, -bmk * tau_inv, 0.0)
    q_b = np.where(on, (bmk + bsi) * tau_inv**2, 0.0)
    q_c = np.where(on, bmk + bsi, 0.0)

    rows = np.concatenate([f, t, f, t])
    cols = np.concatenate([t, f, f, t])
    return (rows, cols, np.concatenate([pij, pji, pii, pjj]),
            np.concatenate([q_a, q_a, q_b, q_c]))


def _fnr_matrices(system: PowerSystem, bx: bool, device=None):
    """Masked dense B' and B'' on ``device``: the matrices of
    ``juliagrid_tpu``'s ``_fnr_matrices``, scattered from their COO
    coefficients on the device instead of built densely on the host."""
    dev = resolve_device(device)
    n = system.bus.number
    rows, cols, p_vals, q_vals = _fnr_coefficients(system, bx)
    bp = linalg.dense_from_coo(rows, cols, p_vals, n, dev)
    bq = linalg.dense_from_coo(rows, cols, q_vals, n, dev)
    # PQ-bus shunt susceptance correction (acPowerFlow.jl:328-334)
    bq.diagonal().add_(torch.as_tensor(
        system.bus.shunt.susceptance.array[:n], device=dev))

    types = torch.as_tensor(system.bus.layout.type.array[:n], device=dev)
    not_slack = torch.arange(n, device=dev) != system.bus.layout.slack
    return (linalg.mask_identity(bp, not_slack),
            linalg.mask_identity(bq, types == 1))


def compile_fnr_arrays(system: PowerSystem, bx: bool,
                       device=None) -> FnrArrays:
    # convert.py builds FnrArrays from numpy and imports this module
    from ..convert import fnr_arrays
    dev = resolve_device(device)
    base = compile_ac_arrays(system, dev)
    bp, bq = _fnr_matrices(system, bx, dev)
    return fnr_arrays(base, bp, bq)


def _fnr_mismatch_pair(arr: FnrArrays, vm, va):
    """V-scaled active/reactive mismatches (acPowerFlow.jl:698-730) from
    one K1 launch: K1's mismatch is already zero at the slack (active) and
    off PQ buses (reactive)."""
    res = nr_fill(arr, vm[None], va[None], arr.p_sched[None],
                  arr.q_sched[None])
    mp, mq = res.mp[0] / vm, res.mq[0] / vm
    return mp, mq, mp.abs().amax(), mq.abs().amax()


def _dense_solves(arr: FnrArrays):
    """The half-step solvers of the dense path: the B' and B'' LU."""
    return partial(linalg.solve, arr.bp), partial(linalg.solve, arr.bq)


def _fnr_half_steps(arr, vm, va, mp, solves):
    """One iteration from the active mismatch ``mp`` at ``(vm, va)``: the
    P half-step, a fresh reactive mismatch at the new angles
    (acPowerFlow.jl:959-970), the Q half-step. ``solves`` is the pair of
    B' and B'' solvers."""
    solve_p, solve_q = solves
    n = vm.shape[0]
    not_slack = torch.arange(n, device=vm.device) != arr.slack
    is_pq = arr.bus_type == 1
    va = va + torch.where(not_slack, solve_p(mp), 0.0)
    res = nr_fill(arr, vm[None], va[None], arr.p_sched[None],
                  arr.q_sched[None])
    mq = res.mq[0] / vm
    vm = vm + torch.where(is_pq, solve_q(mq), 0.0)
    return vm, va


def _fnr_loop(arr, vm, va, tol: float, max_iter: int, solves):
    """Fast decoupled loop: per iteration two K1 launches, the two
    half-step solves and one scalar-pair readback. The count equals the
    number of iterations, and convergence is judged on the freshly
    recomputed mismatch."""
    mp, _, del_p, del_q = _fnr_mismatch_pair(arr, vm, va)
    it = 0
    while True:
        del_p, del_q = torch.stack([del_p, del_q]).tolist()
        converged = del_p < tol and del_q < tol
        if converged or it >= max_iter:
            break
        vm, va = _fnr_half_steps(arr, vm, va, mp, solves)
        it += 1
        mp, _, del_p, del_q = _fnr_mismatch_pair(arr, vm, va)
    return vm, va, it, del_p, del_q, converged


def _fnr_solve(arr: FnrArrays, vm, va, tol: float, max_iter: int,
               kind: str = "LU"):
    """The dense fast decoupled loop, on the B' and B'' LU factors.
    ``kind`` is accepted as the JAX package accepts it: B' and B'' are
    LU-factored whatever it says."""
    return _fnr_loop(arr, vm, va, tol, max_iter, _dense_solves(arr))


def fast_newton_raphson_bx(system: PowerSystem,
                           factorization: str = linalg.LU,
                           device=None) -> AcPowerFlow:
    """Fast decoupled power flow, BX variant, on ``device`` (default
    ``config.device``)."""
    return _fast_newton_raphson(system, True, factorization, device)


def fast_newton_raphson_xb(system: PowerSystem,
                           factorization: str = linalg.LU,
                           device=None) -> AcPowerFlow:
    """Fast decoupled power flow, XB variant, on ``device`` (default
    ``config.device``)."""
    return _fast_newton_raphson(system, False, factorization, device)


def _fast_newton_raphson(system, bx: bool, factorization: str,
                         device) -> AcPowerFlow:
    device = resolve_device(device)
    system.check_slack()
    model(system, "ac")
    magnitude, angle = initialize_ac_power_flow(system)
    arrays = compile_fnr_arrays(system, bx, device)
    rev = system.model.revision
    name = "fast_newton_raphson_bx" if bx else "fast_newton_raphson_xb"
    return AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState(name, factorization),
        arrays=arrays,
        device=device,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )


def fnr_mismatch(analysis: AcPowerFlow):
    """Reference mismatch! for the fast decoupled methods."""
    vm, va = analysis._state()
    _, _, del_p, del_q = _fnr_mismatch_pair(analysis.arrays, vm, va)
    del_p, del_q = torch.stack([del_p, del_q]).tolist()
    analysis.method.max_mismatch_active = del_p
    analysis.method.max_mismatch_reactive = del_q
    return del_p, del_q


def fnr_solve_step(analysis: AcPowerFlow):
    """Reference solve! for the fast decoupled methods: one iteration."""
    vm, va = analysis._state()
    mp, _, _, _ = _fnr_mismatch_pair(analysis.arrays, vm, va)
    vm, va = _fnr_half_steps(analysis.arrays, vm, va, mp,
                             _dense_solves(analysis.arrays))
    analysis.voltage.magnitude = vm.cpu().numpy()
    analysis.voltage.angle = va.cpu().numpy()
    analysis.method.iteration += 1


# ---------------------------------------------------------------------------
# Fast decoupled on the BBD substrate (constant factors amortize perfectly)
# ---------------------------------------------------------------------------

def _fnr_matrices_sparse(system: PowerSystem, bx: bool):
    """Sparse-CSR masked B'/B'' (the coefficients of ``_fnr_coefficients``)
    for the BBD scale path: no dense n x n intermediate."""
    n = system.bus.number
    rows, cols, p_vals, q_vals = _fnr_coefficients(system, bx)
    bp = sp.coo_matrix((p_vals, (rows, cols)), shape=(n, n)).tocsr()
    bq = sp.coo_matrix((q_vals, (rows, cols)), shape=(n, n)).tocsr()
    bq = bq + sp.diags(system.bus.shunt.susceptance.array[:n])

    types = system.bus.layout.type.array[:n]
    slack = system.bus.layout.slack
    m_p = (np.arange(n) != slack).astype(np.float64)
    m_q = (types == 1).astype(np.float64)
    bp = sp.diags(m_p) @ bp @ sp.diags(m_p) + sp.diags(1.0 - m_p)
    bq = sp.diags(m_q) @ bq @ sp.diags(m_q) + sp.diags(1.0 - m_q)
    return bp.tocsr(), bq.tocsr()


def compile_fnr_bbd(system: PowerSystem, bx: bool, n_blocks: int,
                    device=None):
    """The network snapshot and the BBD factors of B' and B'' on
    ``device`` (default ``config.device``); shared by construction and the
    signature refresh."""
    dev = resolve_device(device)
    model(system, "ac")
    base = compile_ac_arrays(system, dev)
    bp, bq = _fnr_matrices_sparse(system, bx)
    # partition on the stored pattern (incl. structural zeros) so the
    # B'/B'' entries — whose pattern is a subset of it — never cross blocks
    nodal = system.model.ac.nodal.tocsr()
    pattern = sp.csr_matrix(
        (np.ones(nodal.nnz), nodal.indices, nodal.indptr), shape=nodal.shape)
    block_of, border = nd_partition(pattern, n_blocks)
    f_p = bbd_precompute(build_bbd_arrays(bp, block_of, border, dev))
    f_q = bbd_precompute(build_bbd_arrays(bq, block_of, border, dev))
    return base, (f_p, f_q)


def fast_newton_raphson_bbd(system: PowerSystem, bx: bool = True,
                            n_blocks: int = 4, device=None) -> AcPowerFlow:
    """Fast decoupled power flow with B'/B'' factored once in BBD form —
    the large-network variant of fast_newton_raphson_bx/xb — on ``device``
    (default ``config.device``)."""
    device = resolve_device(device)
    system.check_slack()
    magnitude, angle = initialize_ac_power_flow(system)
    base, factors = compile_fnr_bbd(system, bx, n_blocks, device)
    rev = system.model.revision
    name = "fast_newton_raphson_bbd_bx" if bx \
        else "fast_newton_raphson_bbd_xb"
    analysis = AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState(name),
        arrays=base,
        device=device,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )
    analysis._bbd_factors = factors
    analysis._bbd_n_blocks = n_blocks
    return analysis


def _fnr_bbd_solve(arr, f_p, f_q, vm, va, tol: float, max_iter: int):
    """The fast decoupled loop on the precomputed BBD factors of B' and
    B''."""
    return _fnr_loop(arr, vm, va, tol, max_iter,
                     (partial(bbd_presolved_solve, f_p),
                      partial(bbd_presolved_solve, f_q)))


def power_flow_fnr_bbd(analysis: AcPowerFlow, iteration: int = 30,
                       tolerance: float = 1e-8):
    """Driver for the BBD fast decoupled analysis."""
    analysis._refresh_arrays()
    f_p, f_q = analysis._bbd_factors
    vm, va = analysis._state()
    vm, va, it, del_p, del_q, conv = _fnr_bbd_solve(
        analysis.arrays, f_p, f_q, vm, va, tolerance, iteration)
    analysis.voltage.magnitude = vm.cpu().numpy()
    analysis.voltage.angle = va.cpu().numpy()
    analysis.method.iteration = it
    analysis.method.converged = conv
    analysis.method.max_mismatch_active = del_p
    analysis.method.max_mismatch_reactive = del_q
    return analysis
