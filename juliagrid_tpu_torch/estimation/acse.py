"""AC state estimation: Gauss-Newton WLS on PyTorch tensors.

Port of ``juliagrid_tpu/estimation/acse.py`` (a redesign of JuliaGrid
src/stateEstimation/acStateEstimation.jl). The 21 typed measurement rows
(reference :131-236) are grouped by type into static index arrays on the
host (``compile_se_arrays``), together with a per-row descriptor table for
kernel K3 (``kernels/se_fill.py``). Each Gauss-Newton iteration of the
normal equations is one launch of K3's entry mode — h(x), the residuals and
H as its entry list (``h_entry_pattern`` order) with inactive rows and the
slack column masked, as the JAX package's ``gn_increment`` keeps it — then
one launch of kernel K8 (``kernels/gain_fill.py``), which forms the gain
``HᵀWH + HᵀPH + e_s e_sᵀ`` (the correlated-PMU pair terms included) and
``HᵀW r`` from H's fixed entry pattern, and an f64 Cholesky solve (one
launch of kernel K2, ``kernels/fleet_solve.py``, up to 256 unknowns,
``torch.linalg`` above). QR / Peters-Wilkinson on W½H (Orthogonal,
reference :906-971) fill the dense H (K3's dense mode). The H100 has native
f64, so the JAX package's f32 gain and its residual-gated f64 refinement
are gone; ``rel``, the relative residual of the normal equations, stays and
still escalates an ill-conditioned solve to QR.

The loop is a host loop with one scalar readback per iteration. Iteration
semantics match stateEstimation! (:1286-1329): the increment is computed,
convergence is judged on max|dx| before applying it, and the count equals
the number of applied increments.

PMU semantics are preserved exactly: polar vs rectangular rows, squared
magnitudes (varianceSquare), rectangular error propagation
(equations.jl:576-588), and correlated 2x2 precision blocks applied as
paired row corrections.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..kernels import fleet_solve, gain_fill
from ..kernels.se_fill import SeFillTable, se_fill, se_fill_entries
from ..ops import equations as eq
from ..ops import linalg
from ..ops.equations import BRANCH_GROUPS
from ..powerflow.ac import AcArrays, Polar, compile_ac_arrays
from ..system.model import model
from ..system.types import PowerSystem
from ..utils.errors import MethodError_
from ..utils.profiling import Timings, default_timings, mark


class BranchGroup(NamedTuple):
    rows: torch.Tensor   # i64[k] measurement row ids
    f: torch.Tensor      # i64[k] from-bus
    t: torch.Tensor      # i64[k] to-bus
    a: torch.Tensor      # f64[k] PiModel coefficients
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    phi: torch.Tensor    # f64[k] transformer shift angle


class SeArrays(NamedTuple):
    """The measurement-row IR on a device (index fields int64), or its
    numpy host mirror (index fields int32, as the JAX package's)."""

    mean: torch.Tensor        # f64[m] (status-masked)
    w: torch.Tensor           # f64[m] diagonal precision
    status: torch.Tensor      # f64[m] 0/1 row mask
    pair_r1: torch.Tensor     # i64[p] correlated PMU row pairs
    pair_r2: torch.Tensor
    pair_off: torch.Tensor    # f64[p] off-diagonal precision
    slack: int                # slack bus (host int: no device readback)
    # voltage-magnitude rows (types 1, 12)
    vm_rows: torch.Tensor
    vm_bus: torch.Tensor
    # voltage-angle rows (type 13)
    va_rows: torch.Tensor
    va_bus: torch.Tensor
    # rectangular bus phasor rows (types 16, 17)
    rev_rows: torch.Tensor
    rev_bus: torch.Tensor
    imv_rows: torch.Tensor
    imv_bus: torch.Tensor
    # branch groups, in BRANCH_GROUPS order
    branch: tuple
    # injection rows (types 6, 9): per-measurement and flattened Y entries
    p_rows: torch.Tensor      # i64[mp]
    p_bus: torch.Tensor
    p_ent_meas: torch.Tensor  # i64[E] scatter: measurement row per Y entry
    p_ent_k: torch.Tensor     # i64[E] Y entry index
    q_rows: torch.Tensor
    q_bus: torch.Tensor
    q_ent_meas: torch.Tensor
    q_ent_k: torch.Tensor
    # K3's per-row descriptor table (None in the host mirror)
    desc: Optional[SeFillTable] = None


@dataclass
class SeMethod:
    name: str
    factorization: str = linalg.LU
    iteration: int = 0
    converged: bool = False
    max_increment: float = np.inf
    objective: float = 0.0
    residual: Optional[np.ndarray] = None
    jacobian: Optional[np.ndarray] = None
    precision_diag: Optional[np.ndarray] = None
    mean: Optional[np.ndarray] = None
    type: Optional[np.ndarray] = None
    row_device: Optional[list] = None
    #: largest relative residual ‖rhs − G dx‖ / ‖rhs‖ of the normal
    #: equations over the last solve (inf where the Cholesky failed)
    refine_residual: float = 0.0
    #: set when that residual sent the solve to the QR path
    refine_escalated: bool = False
    timings: Timings = field(default_factory=Timings)
    _pending_dx: Optional[np.ndarray] = field(default=None, repr=False)


@dataclass
class AcStateEstimation:
    system: PowerSystem
    monitoring: object
    voltage: Polar
    method: SeMethod
    arrays: SeArrays
    net: AcArrays
    device: torch.device
    power: Optional[object] = None
    current: Optional[object] = None
    kind: str = "state_estimation"
    signature: dict = field(default_factory=dict)

    def _refresh_arrays(self):
        rev = self.system.model.revision
        mrev = self.monitoring.revision
        sig = self.signature
        if sig and sig.get("slack") != rev.slack:
            # angle datum moved with the slack: shift the live state's
            # angles uniformly so the new slack sits at the system's stored
            # angle — the datum a fresh build pins (flows and residuals are
            # datum-invariant)
            bus = self.system.bus
            slack = bus.layout.slack
            va = np.asarray(self.voltage.angle, dtype=float).copy()
            va = va + (float(bus.voltage.angle[slack]) - va[slack])
            self.voltage.angle = va
        if (sig.get("ac_model") != rev.ac_model
                or sig.get("measurement") != mrev.measurement
                or sig.get("slack") != rev.slack):
            (self.arrays, self.method.type,
             self.method.row_device) = compile_se_arrays(
                self.system, self.monitoring, device=self.device)
            self.net = compile_ac_arrays(self.system, self.device)
            sig.update(ac_model=rev.ac_model, measurement=mrev.measurement,
                       meas_values=mrev.values, slack=rev.slack)
        elif sig.get("meas_values") != mrev.values:
            # numeric-only edit (update_*meter means/variances/statuses):
            # patch the per-row value vectors in place — the reference's
            # live row patches (powermeter.jl:629-958, pmu.jl:566-915). The
            # index patterns and K3's descriptor table stay untouched.
            values = compile_se_arrays(self.system, self.monitoring,
                                       values_only=True)
            mean, w, status, pair_off = (
                torch.tensor(v, dtype=torch.float64, device=self.device)
                for v in values)
            self.arrays = self.arrays._replace(
                mean=mean, w=w, status=status, pair_off=pair_off)
            sig["meas_values"] = mrev.values

    def _state(self):
        """The host voltage state as f64 tensors on the analysis device."""
        return (torch.as_tensor(self.voltage.magnitude, dtype=torch.float64,
                                device=self.device),
                torch.as_tensor(self.voltage.angle, dtype=torch.float64,
                                device=self.device))


def compile_se_arrays(system: PowerSystem, monitoring,
                      return_host: bool = False, values_only: bool = False,
                      device=None):
    """Build the measurement-row IR (reference acWLS, :77-259): rows in
    device order — voltmeters, ammeters, wattmeters, varmeters, PMUs (PMUs
    contribute two rows each) — on ``device`` (default ``config.device``),
    with K3's descriptor table.

    ``values_only=True`` runs just the device walk and returns the
    ``(mean, w, status, pair_off)`` host vectors — the live row-value
    patch used by ``_refresh_arrays`` when only means/variances/statuses
    changed (the index patterns and branch coefficients are still valid).
    ``return_host=True`` also returns the numpy host mirror."""
    model(system, "ac")
    n = system.bus.number
    volt, amp = monitoring.voltmeter, monitoring.ammeter
    watt, var, pmu = monitoring.wattmeter, monitoring.varmeter, monitoring.pmu

    if not values_only:
        coo = system.model.ac.nodal.tocoo()
        order = np.lexsort((coo.col, coo.row))
        yrows = coo.row[order]

    mean, w, status, types = [], [], [], []
    row_device = []  # (device kind, device index) per measurement row
    vm_rows, vm_bus, va_rows, va_bus = [], [], [], []
    rev_rows, rev_bus, imv_rows, imv_bus = [], [], [], []
    br_groups = {t: ([], []) for t, _, _ in BRANCH_GROUPS}  # rows, branch
    p_rows, p_bus, q_rows, q_bus = [], [], [], []
    pair_r1, pair_r2, pair_off = [], [], []

    row = 0

    def push(m_, v_, st_, ty_):
        nonlocal row
        mean.append(st_ * m_)
        w.append(1.0 / v_)
        status.append(float(st_))
        types.append(ty_)
        row += 1

    for i in range(volt.number):
        k = int(volt.layout.index[i])
        st = int(volt.magnitude.status[i])
        vm_rows.append(row)
        vm_bus.append(k)
        row_device.append(("voltmeter", i))
        push(volt.magnitude.mean[i], volt.magnitude.variance[i], st, 1)

    for i in range(amp.number):
        k = int(amp.layout.index[i])
        st = int(amp.magnitude.status[i])
        sq = bool(amp.layout.square[i])
        is_from = bool(amp.layout.from_[i])
        ty = (4 if is_from else 5) if sq else (2 if is_from else 3)
        br_groups[ty][0].append(row)
        br_groups[ty][1].append(k)
        row_device.append(("ammeter", i))
        m_val = amp.magnitude.mean[i] ** (2 if sq else 1)
        v_val = amp.magnitude.variance[i]
        if sq:
            v_val = 4 * amp.magnitude.mean[i] ** 2 * v_val
        push(m_val, v_val, st, ty)

    for i in range(watt.number):
        k = int(watt.layout.index[i])
        st = int(watt.active.status[i])
        row_device.append(("wattmeter", i))
        if watt.layout.bus[i]:
            p_rows.append(row)
            p_bus.append(k)
            push(watt.active.mean[i], watt.active.variance[i], st, 6)
        else:
            ty = 7 if watt.layout.from_[i] else 8
            br_groups[ty][0].append(row)
            br_groups[ty][1].append(k)
            push(watt.active.mean[i], watt.active.variance[i], st, ty)

    for i in range(var.number):
        k = int(var.layout.index[i])
        st = int(var.reactive.status[i])
        row_device.append(("varmeter", i))
        if var.layout.bus[i]:
            q_rows.append(row)
            q_bus.append(k)
            push(var.reactive.mean[i], var.reactive.variance[i], st, 9)
        else:
            ty = 10 if var.layout.from_[i] else 11
            br_groups[ty][0].append(row)
            br_groups[ty][1].append(k)
            push(var.reactive.mean[i], var.reactive.variance[i], st, ty)

    for i in range(pmu.number):
        row_device.append(("pmu", i))
        row_device.append(("pmu", i))
        k = int(pmu.layout.index[i])
        st_m = int(pmu.magnitude.status[i])
        st_a = int(pmu.angle.status[i])
        if pmu.layout.polar[i]:
            sq = bool(pmu.layout.square[i])
            if pmu.layout.bus[i]:
                vm_rows.append(row)
                vm_bus.append(k)
                push(pmu.magnitude.mean[i], pmu.magnitude.variance[i],
                     st_m, 12)
                va_rows.append(row)
                va_bus.append(k)
                push(pmu.angle.mean[i], pmu.angle.variance[i], st_a, 13)
            else:
                is_from = bool(pmu.layout.from_[i])
                ty = (4 if is_from else 5) if sq else (2 if is_from else 3)
                br_groups[ty][0].append(row)
                br_groups[ty][1].append(k)
                m_val = pmu.magnitude.mean[i] ** (2 if sq else 1)
                v_val = pmu.magnitude.variance[i]
                if sq:
                    v_val = 4 * pmu.magnitude.mean[i] ** 2 * v_val
                push(m_val, v_val, st_m, ty)
                ty_a = 14 if is_from else 15
                br_groups[ty_a][0].append(row)
                br_groups[ty_a][1].append(k)
                push(pmu.angle.mean[i], pmu.angle.variance[i], st_a, ty_a)
        else:
            st = st_m * st_a
            mag, ang = pmu.magnitude.mean[i], pmu.angle.mean[i]
            cos_t, sin_t = np.cos(ang), np.sin(ang)
            var_re, var_im = eq.variance_pmu(
                pmu.magnitude.variance[i], pmu.angle.variance[i],
                mag, cos_t, sin_t)
            if pmu.layout.correlated[i]:
                w11, w22, off = eq.covariance_pmu(
                    pmu.magnitude.variance[i], pmu.angle.variance[i],
                    mag, cos_t, sin_t, var_re, var_im)
                pair_r1.append(row)
                pair_r2.append(row + 1)
                pair_off.append(off)
                weights = (w11, w22)
            else:
                weights = (1.0 / var_re, 1.0 / var_im)
            if pmu.layout.bus[i]:
                rev_rows.append(row)
                rev_bus.append(k)
                mean.append(st * mag * cos_t)
                w.append(weights[0])
                status.append(float(st))
                types.append(16)
                row += 1
                imv_rows.append(row)
                imv_bus.append(k)
                mean.append(st * mag * sin_t)
                w.append(weights[1])
                status.append(float(st))
                types.append(17)
                row += 1
            else:
                is_from = bool(pmu.layout.from_[i])
                ty_re = 18 if is_from else 19
                ty_im = 20 if is_from else 21
                br_groups[ty_re][0].append(row)
                br_groups[ty_re][1].append(k)
                mean.append(st * mag * cos_t)
                w.append(weights[0])
                status.append(float(st))
                types.append(ty_re)
                row += 1
                br_groups[ty_im][0].append(row)
                br_groups[ty_im][1].append(k)
                mean.append(st * mag * sin_t)
                w.append(weights[1])
                status.append(float(st))
                types.append(ty_im)
                row += 1

    if values_only:
        return (np.asarray(mean), np.asarray(w), np.asarray(status),
                np.asarray(pair_off))

    # ---- host mirror -----------------------------------------------------
    f_all = system.branch.layout.from_bus.array[: system.branch.number]
    t_all = system.branch.layout.to_bus.array[: system.branch.number]

    groups = []
    for ty, coeff_fn, _ in BRANCH_GROUPS:
        rows_, brs_ = br_groups[ty]
        brs_np = np.asarray(brs_, dtype=np.int64)
        co = coeff_fn(system, brs_np) if len(brs_) else eq.PiCoeff(
            *(np.empty(0),) * 4)
        phi_all = system.branch.parameter.shift_angle.array[
            : system.branch.number]
        groups.append(BranchGroup(
            rows=np.asarray(rows_, dtype=np.int32),
            f=f_all[brs_np].astype(np.int32),
            t=t_all[brs_np].astype(np.int32),
            a=np.asarray(co.a), b=np.asarray(co.b),
            c=np.asarray(co.c), d=np.asarray(co.d),
            phi=np.asarray(phi_all[brs_np])))

    # bus -> Y-entry index ranges, precomputed once (one searchsorted instead
    # of a scan of the entry list per injection row)
    y_order = np.argsort(yrows, kind="stable")
    y_starts = np.searchsorted(yrows[y_order], np.arange(n + 1))

    def _inj_entries(rows_list, bus_list):
        ent_meas, ent_k = [], []
        for r_, b_ in zip(rows_list, bus_list):
            ks = y_order[y_starts[b_]:y_starts[b_ + 1]]
            ent_meas.extend([r_] * len(ks))
            ent_k.extend(ks.tolist())
        return (np.asarray(ent_meas, dtype=np.int32),
                np.asarray(ent_k, dtype=np.int32))

    p_ent_meas, p_ent_k = _inj_entries(p_rows, p_bus)
    q_ent_meas, q_ent_k = _inj_entries(q_rows, q_bus)

    arr_host = SeArrays(
        mean=np.asarray(mean, dtype=np.float64),
        w=np.asarray(w, dtype=np.float64),
        status=np.asarray(status, dtype=np.float64),
        pair_r1=np.asarray(pair_r1, dtype=np.int32),
        pair_r2=np.asarray(pair_r2, dtype=np.int32),
        pair_off=np.asarray(pair_off, dtype=np.float64),
        slack=np.int32(system.bus.layout.slack),
        vm_rows=np.asarray(vm_rows, dtype=np.int32),
        vm_bus=np.asarray(vm_bus, dtype=np.int32),
        va_rows=np.asarray(va_rows, dtype=np.int32),
        va_bus=np.asarray(va_bus, dtype=np.int32),
        rev_rows=np.asarray(rev_rows, dtype=np.int32),
        rev_bus=np.asarray(rev_bus, dtype=np.int32),
        imv_rows=np.asarray(imv_rows, dtype=np.int32),
        imv_bus=np.asarray(imv_bus, dtype=np.int32),
        branch=tuple(groups),
        p_rows=np.asarray(p_rows, dtype=np.int32),
        p_bus=np.asarray(p_bus, dtype=np.int32),
        p_ent_meas=p_ent_meas, p_ent_k=p_ent_k,
        q_rows=np.asarray(q_rows, dtype=np.int32),
        q_bus=np.asarray(q_bus, dtype=np.int32),
        q_ent_meas=q_ent_meas, q_ent_k=q_ent_k,
    )
    # convert.py builds SeArrays from numpy and imports this module
    from ..convert import se_arrays_from_numpy
    arr = se_arrays_from_numpy(arr_host, device)
    types = np.asarray(types, dtype=np.int8)
    if return_host:
        return arr, types, row_device, arr_host
    return arr, types, row_device


# --------------------------------------------------------------------------
# Jacobian/residual evaluation (tensors; states ``[n]`` or ``[B, n]``)
# --------------------------------------------------------------------------

def h_entry_pattern(arr: SeArrays, net: AcArrays, n: int):
    """(rows, cols) of every H entry, in the exact order ``h_entries``
    emits values. Cols index the 2n state vector (θ then V)."""
    rows, cols = [], []

    def add(r, c):
        rows.append(r)
        cols.append(c)

    add(arr.vm_rows, n + arr.vm_bus)
    add(arr.va_rows, arr.va_bus)
    add(arr.rev_rows, arr.rev_bus)
    add(arr.rev_rows, n + arr.rev_bus)
    add(arr.imv_rows, arr.imv_bus)
    add(arr.imv_rows, n + arr.imv_bus)
    for grp in arr.branch:
        if grp.rows.shape[0] == 0:
            continue
        add(grp.rows, grp.f)
        add(grp.rows, grp.t)
        add(grp.rows, n + grp.f)
        add(grp.rows, n + grp.t)
    net_cols = net.cols.long()
    if arr.p_rows.shape[0]:
        ke = arr.p_ent_k
        add(arr.p_ent_meas, net_cols[ke])
        add(arr.p_ent_meas, n + net_cols[ke])
        add(arr.p_rows, arr.p_bus)
        add(arr.p_rows, n + arr.p_bus)
    if arr.q_rows.shape[0]:
        ke = arr.q_ent_k
        add(arr.q_ent_meas, net_cols[ke])
        add(arr.q_ent_meas, n + net_cols[ke])
        add(arr.q_rows, arr.q_bus)
        add(arr.q_rows, n + arr.q_bus)
    return torch.cat(rows), torch.cat(cols)


def h_entries(arr: SeArrays, net: AcArrays, vm, va):
    """Per-entry H values (pattern order = ``h_entry_pattern``) + h(x)
    times row status, for states ``[..., n]``: the plain version of K3's
    row evaluation (``kernels/se_fill.py::se_fill_ref`` scatters it)."""
    n = vm.shape[-1]
    lead = vm.shape[:-1]
    h = torch.zeros(lead + (arr.mean.shape[0],), dtype=vm.dtype,
                    device=vm.device)
    vals = []

    def ones(k):
        return torch.ones(lead + (k,), dtype=vm.dtype, device=vm.device)

    vals.append(ones(arr.vm_rows.shape[0]))
    h.index_add_(-1, arr.vm_rows, vm[..., arr.vm_bus])
    vals.append(ones(arr.va_rows.shape[0]))
    h.index_add_(-1, arr.va_rows, va[..., arr.va_bus])

    cb = torch.cos(va[..., arr.rev_bus])
    sb = torch.sin(va[..., arr.rev_bus])
    vals.append(-vm[..., arr.rev_bus] * sb)
    vals.append(cb)
    h.index_add_(-1, arr.rev_rows, vm[..., arr.rev_bus] * cb)
    ci = torch.cos(va[..., arr.imv_bus])
    si = torch.sin(va[..., arr.imv_bus])
    vals.append(vm[..., arr.imv_bus] * ci)
    vals.append(si)
    h.index_add_(-1, arr.imv_rows, vm[..., arr.imv_bus] * si)

    # branch groups
    for (ty, _, eval_fn), grp in zip(BRANCH_GROUPS, arr.branch):
        if grp.rows.shape[0] == 0:
            continue
        vi, vj = vm[..., grp.f], vm[..., grp.t]
        ti, tj = va[..., grp.f], va[..., grp.t]
        # the reference evaluates branch rows at θij - φ (equations.jl:
        # ViVjθijState / ViVjθiθjState / VjViθjθiState): from-side rows
        # shift θj by +φ, to-side phasor rows shift θi by -φ.
        if ty in (15, 19, 21):
            ti = ti - grp.phi
        else:
            tj = tj + grp.phi
        co = eq.PiCoeff(grp.a, grp.b, grp.c, grp.d)
        hv, dti, dtj, dvi, dvj = eval_fn(co, vi, vj, ti, tj)
        h.index_add_(-1, grp.rows, hv)
        vals.extend([dti, dtj, dvi, dvj])

    # injections (6, 9)
    if arr.p_rows.shape[0] or arr.q_rows.shape[0]:
        rows, cols = net.rows.long(), net.cols.long()
        vi_e = vm[..., rows]
        vj_e = vm[..., cols]
        th_e = va[..., rows] - va[..., cols]
        st_e, ct_e = torch.sin(th_e), torch.cos(th_e)
        vv = vi_e * vj_e
        t1 = vv * (net.yg * ct_e + net.yb * st_e)
        t2 = vv * (net.yg * st_e - net.yb * ct_e)
        zeros = torch.zeros(lead + (n,), dtype=vm.dtype, device=vm.device)
        p_bus_all = zeros.index_add(-1, rows, t1)
        q_bus_all = zeros.index_add(-1, rows, t2)
        off = (rows != cols).to(vm.dtype)
        # dP/dθj, dP/dVj per entry (off-diagonal)
        dp_dtj = t2 * off
        dp_dvj = (vi_e * (net.yg * ct_e + net.yb * st_e)) * off
        dq_dtj = -t1 * off
        dq_dvj = (vi_e * (net.yg * st_e - net.yb * ct_e)) * off
        diag = net.diag.long()
        gii = net.yg[diag]
        bii = net.yb[diag]

        if arr.p_rows.shape[0]:
            pb = arr.p_bus
            h.index_add_(-1, arr.p_rows, p_bus_all[..., pb])
            ke = arr.p_ent_k
            vals.append(dp_dtj[..., ke])
            vals.append(dp_dvj[..., ke])
            vals.append(-q_bus_all[..., pb] - bii[pb] * vm[..., pb] ** 2)
            vals.append(p_bus_all[..., pb] / vm[..., pb]
                        + gii[pb] * vm[..., pb])
        if arr.q_rows.shape[0]:
            qb = arr.q_bus
            h.index_add_(-1, arr.q_rows, q_bus_all[..., qb])
            ke = arr.q_ent_k
            vals.append(dq_dtj[..., ke])
            vals.append(dq_dvj[..., ke])
            vals.append(p_bus_all[..., qb] - gii[qb] * vm[..., qb] ** 2)
            vals.append(q_bus_all[..., qb] / vm[..., qb]
                        - bii[qb] * vm[..., qb])

    return torch.cat(vals, dim=-1), h * arr.status


def build_h(arr: SeArrays, net: AcArrays, vm, va):
    """Dense measurement Jacobian H (m x 2n, inactive rows zeroed, slack
    column kept) and model values h(x) at the state ``[n]``: one K3
    launch."""
    res = se_fill(arr, net, vm[None], va[None], arr.mean[None],
                  jacobian=True, mask_slack=False)
    return res.jac[0], res.h[0]


def _weighted(arr: SeArrays, H, r):
    """Apply W (diagonal + correlated 2x2 blocks) to H ``[..., m, 2n]`` and
    r ``[..., m]``."""
    WH = arr.w[:, None] * H
    if arr.pair_r1.shape[0]:
        off = arr.pair_off[:, None]
        WH = WH.index_add(-2, arr.pair_r1, off * H[..., arr.pair_r2, :])
        WH = WH.index_add(-2, arr.pair_r2, off * H[..., arr.pair_r1, :])
    return WH, _w_apply_vec(arr, r)


def _w_apply_vec(arr: SeArrays, v):
    """Apply W (diagonal + correlated 2x2 blocks) to residuals ``[..., m]``."""
    wv = arr.w * v
    if arr.pair_r1.shape[0]:
        wv = wv.index_add(-1, arr.pair_r1, arr.pair_off * v[..., arr.pair_r2])
        wv = wv.index_add(-1, arr.pair_r2, arr.pair_off * v[..., arr.pair_r1])
    return wv


def _col_mask(arr: SeArrays, n: int, like) -> torch.Tensor:
    """1 on every state column but the slack angle's."""
    mask = torch.ones(2 * n, dtype=like.dtype, device=like.device)
    mask[arr.slack] = 0.0
    return mask


def _solve_normal(arr: SeArrays, gain, rhs):
    """f64 Cholesky solve of the normal equations: ``dx [B, 2n]``,
    ``max|dx| [B]`` and ``rel [B]`` = ‖rhs − G dx‖ / ‖rhs‖ (inf where the
    factorization fails): ``fleet_cholesky_solve``, which picks K2 or the
    library route by device and order."""
    dx, info = fleet_solve.fleet_cholesky_solve(gain, rhs)
    resid = rhs - (gain @ dx[..., None])[..., 0]
    rel = resid.norm(dim=-1) / (rhs.norm(dim=-1) + 1e-300)
    rel = torch.where(info != 0, torch.inf, rel)
    dx = dx * _col_mask(arr, rhs.shape[-1] // 2, dx)
    return dx, dx.abs().amax(-1), rel


def gain_table(arr: SeArrays, net: AcArrays) -> gain_fill.GainTable:
    """K8's tables of the measurement set ``arr`` on ``net``, built once
    per entry pattern (``h_entry_pattern``, the correlated pairs, the
    slack): status, mean and variance edits keep them."""
    n = net.row_ptr.numel() - 1

    def build():
        rows, cols = h_entry_pattern(arr, net, n)
        host = gain_fill.gain_fill_table(
            rows.cpu().numpy(), cols.cpu().numpy(), arr.mean.shape[0], 2 * n,
            arr.pair_r1.cpu().numpy(), arr.pair_r2.cpu().numpy(), arr.slack)
        return gain_fill.device_table(host, arr.mean.device)

    return gain_fill.cached_table(arr.desc.idx,
                                  (net.cols, arr.pair_r1, arr.slack), build)


def _gain_equations(arr: SeArrays, net: AcArrays, vm, va, mean,
                    fill=se_fill_entries, gain=gain_fill.gain_fill):
    """Gain ``G = HᵀWH + HᵀPH + e_s e_sᵀ`` and right-hand side ``HᵀW r``
    (W with the correlated pairs) for ``[B, n]`` states and ``[B, m]``
    means: one launch of K3's entry mode, one of K8. Marks the stages
    ``fill`` and ``gain`` (``utils.profiling.mark``)."""
    try:
        mark("fill")
        res = fill(arr, net, vm, va, mean)
        mark("gain")
        return gain(gain_table(arr, net), res.vals, arr.w, arr.pair_off,
                    res.r)
    finally:
        mark(None)


def _normal_increment(arr: SeArrays, net: AcArrays, vm, va, mean,
                      fill=se_fill_entries, gain=gain_fill.gain_fill):
    """Gauss-Newton increments of the normal equations for ``[B, n]``
    states and ``[B, m]`` means: K3's entry mode, K8's gain and an f64
    Cholesky. Returns ``dx [B, 2n]``, ``max|dx| [B]`` and ``rel [B]``.
    ``fill`` and ``gain`` exist so a check can run the same step on
    ``se_fill_entries_ref`` and ``gain_fill_ref``; the main path never
    passes them. Marks ``fill``, ``gain`` and ``solve``."""
    g, rhs = _gain_equations(arr, net, vm, va, mean, fill, gain)
    try:
        mark("solve")
        return _solve_normal(arr, g, rhs)
    finally:
        mark(None)


def _sqrt_increment(arr: SeArrays, net: AcArrays, vm, va, kind: str):
    """One increment of a square-root method on W½H (diagonal weights
    only): Orthogonal (QR) or Peters-Wilkinson (tall LU + L-normal
    equations), at the state ``[n]``."""
    n = vm.shape[0]
    res = se_fill(arr, net, vm[None], va[None], arr.mean[None])
    sw = arr.w.sqrt()
    # append an identity row for the slack column to keep A full rank
    e = torch.zeros((1, 2 * n), dtype=vm.dtype, device=vm.device)
    e[0, arr.slack] = 1.0
    a = torch.cat([sw[:, None] * res.jac[0], e], dim=0)
    b = torch.cat([sw * res.r[0], torch.zeros_like(sw[:1])])
    if kind == linalg.PW:
        dx = linalg.pw_lsq_solve(a, b)
    else:
        dx = linalg.solve(linalg.factorize(a, linalg.QR), b)
    dx = dx * _col_mask(arr, n, dx)
    rel = torch.zeros((), dtype=vm.dtype, device=vm.device)  # no gate
    return dx, dx.abs().amax(), rel


def gn_increment(arr: SeArrays, net: AcArrays, vm, va, kind: str):
    """One Gauss-Newton increment at the state ``[n]`` (reference
    increment!, :878-931): ``(dx [2n], max|dx|, rel)`` as tensors. Kinds
    LU/KLU/LL/LDLt take the normal equations (f64 Cholesky), QR and PW
    the square-root methods."""
    if kind in (linalg.QR, linalg.PW):
        return _sqrt_increment(arr, net, vm, va, kind)
    dx, maxinc, rel = _normal_increment(arr, net, vm[None], va[None],
                                        arr.mean[None])
    return dx[0], maxinc[0], rel[0]


def _se_solve(arr: SeArrays, net: AcArrays, vm, va, tol: float,
              max_iter: int, kind: str):
    """Gauss-Newton loop from the state ``[n]``: one increment (one K3
    launch) and one scalar readback per iteration. Returns ``(vm, va,
    iterations, max|dx|, converged, relmax)``."""
    n = vm.shape[0]
    dx, maxinc, relmax = gn_increment(arr, net, vm, va, kind)
    inc = float(maxinc)
    it = 0
    while inc >= tol and it < max_iter:
        va = va + dx[:n]
        vm = vm + dx[n:]
        dx, maxinc, rel = gn_increment(arr, net, vm, va, kind)
        relmax = torch.maximum(relmax, rel)
        inc = float(maxinc)
        it += 1
    return vm, va, it, inc, inc < tol, float(relmax)


def _wls_objective(arr: SeArrays, net: AcArrays, vm, va):
    """J(x) = r' W r (incl. correlated PMU cross terms) at the state
    ``[n]``: one K3 launch without the Jacobian."""
    r = se_fill(arr, net, vm[None], va[None], arr.mean[None],
                jacobian=False).r[0]
    val = torch.sum(arr.w * r * r)
    if arr.pair_r1.shape[0]:
        val = val + torch.sum(2.0 * arr.pair_off * r[arr.pair_r1]
                              * r[arr.pair_r2])
    return val


def _se_solve_damped(arr: SeArrays, net: AcArrays, vm, va, tol: float,
                     max_iter: int, kind: str):
    """Gauss-Newton with backtracking on the WLS objective — robust for
    low-redundancy / polar-phasor sets from flat starts (the reference's
    plain iteration can diverge there)."""
    n = vm.shape[0]
    dx, maxinc, relmax = gn_increment(arr, net, vm, va, kind)
    inc = float(maxinc)
    it = 0
    while inc >= tol and it < max_iter:
        j0 = float(_wls_objective(arr, net, vm, va))
        alpha = 1.0
        j_new = float(_wls_objective(arr, net, vm + dx[n:], va + dx[:n]))
        while j_new > j0 and alpha > 0.03:
            alpha *= 0.5
            j_new = float(_wls_objective(arr, net, vm + alpha * dx[n:],
                                         va + alpha * dx[:n]))
        va = va + alpha * dx[:n]
        vm = vm + alpha * dx[n:]
        dx, maxinc, rel = gn_increment(arr, net, vm, va, kind)
        relmax = torch.maximum(relmax, rel)
        inc = float(maxinc)
        it += 1
    return vm, va, it, inc, inc < tol, float(relmax)


# --------------------------------------------------------------------------
# API
# --------------------------------------------------------------------------

def _kind(analysis: AcStateEstimation) -> str:
    fact = analysis.method.factorization
    return fact if fact in (linalg.QR, linalg.PW) else linalg.LU


def gauss_newton(monitoring, factorization: str = linalg.LU,
                 device=None) -> AcStateEstimation:
    """Reference gaussNewton (acStateEstimation.jl:43-75), on ``device``
    (default ``config.device``)."""
    device = resolve_device(device)
    system = monitoring.system
    system.check_slack()
    model(system, "ac")
    n = system.bus.number
    if factorization in (linalg.QR, linalg.PW):
        pmu = monitoring.pmu
        npmu = pmu.number
        corr = pmu.layout.correlated.array[:npmu].astype(bool)
        polar = pmu.layout.polar.array[:npmu].astype(bool)
        if np.any(corr & ~polar):
            # reference acStateEstimation.jl:47-49: the 2x2 off-diagonal
            # precision blocks cannot ride the W^1/2 H orthogonal path
            raise MethodError_(
                "A non-diagonal precision matrix prevents the use of the "
                "select method.")
    arr, types, row_device = compile_se_arrays(system, monitoring,
                                               device=device)
    net = compile_ac_arrays(system, device)
    rev = system.model.revision
    method = SeMethod("gauss_newton", factorization)
    method.type = types
    method.row_device = row_device
    return AcStateEstimation(
        system=system,
        monitoring=monitoring,
        voltage=Polar(system.bus.voltage.magnitude.array[:n].copy(),
                      system.bus.voltage.angle.array[:n].copy()),
        method=method,
        arrays=arr,
        net=net,
        device=device,
        signature={"ac_model": rev.ac_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values,
                   "slack": rev.slack},
    )


def increment(analysis: AcStateEstimation) -> float:
    """Reference increment!: compute (but do not apply) the GN step."""
    analysis._refresh_arrays()
    vm, va = analysis._state()
    dx, maxinc, rel = gn_increment(analysis.arrays, analysis.net, vm, va,
                                   _kind(analysis))
    analysis.method._pending_dx = dx.cpu().numpy()
    analysis.method.max_increment = float(maxinc)
    analysis.method.refine_residual = float(rel)
    return analysis.method.max_increment


def solve(analysis: AcStateEstimation):
    """Reference solve!: apply the pending increment."""
    dx = analysis.method._pending_dx
    if dx is None:
        increment(analysis)
        dx = analysis.method._pending_dx
    n = analysis.system.bus.number
    analysis.voltage.angle = analysis.voltage.angle + dx[:n]
    analysis.voltage.magnitude = analysis.voltage.magnitude + dx[n:]
    analysis.method.iteration += 1
    analysis.method._pending_dx = None


def state_estimation(analysis, iteration: int = 40, tolerance: float = 1e-8,
                     power: bool = False, current: bool = False,
                     damping: bool = False, verbose: int | None = None):
    """Reference stateEstimation!, dispatched on the analysis type and its
    method: Gauss-Newton, DC and PMU WLS, and the three LAV kinds. (The
    JAX package sends DC and PMU LAV analyses to the WLS solvers.)"""
    from .dcse import DcStateEstimation, dc_se_solve
    from .pmuse import PmuStateEstimation, pmu_se_solve
    if isinstance(analysis, DcStateEstimation):
        if analysis.method.name == "dc_lav":
            from .lav import dc_lav_solve
            return dc_lav_solve(analysis, iteration=iteration, power=power)
        return dc_se_solve(analysis, power=power)
    if isinstance(analysis, PmuStateEstimation):
        if analysis.method.name == "pmu_lav":
            from .lav import pmu_lav_solve
            return pmu_lav_solve(analysis, iteration=iteration, power=power,
                                 current=current)
        return pmu_se_solve(analysis, power=power, current=current)
    if analysis.method.name == "lav":
        from .lav import lav_solve
        return lav_solve(analysis, iteration=iteration, power=power,
                         current=current)
    if not isinstance(analysis, AcStateEstimation):
        raise NotImplementedError(
            f"state_estimation runs Gauss-Newton, DC, PMU and LAV analyses; "
            f"{type(analysis).__name__} is not ported")
    method = analysis.method
    with method.timings.span("refresh"), default_timings.span("se.refresh"):
        analysis._refresh_arrays()
    method.iteration = 0
    kind = _kind(analysis)
    verbose = 0 if verbose is None else verbose

    if verbose >= 2:
        # reference print/solver.jl verbose tables: stepwise host loop
        from ..report.solver import (print_exit, print_middle_se,
                                     print_residuals_se, print_solver_se,
                                     print_top_se)
        print_top_se(analysis.monitoring, verbose)
        residuals(analysis)
        print_middle_se(analysis.system, analysis, verbose)
        converged = False
        for _ in range(iteration + 1):
            maxinc = increment(analysis)
            vm, va = analysis._state()
            obj = float(_wls_objective(analysis.arrays, analysis.net, vm, va))
            print_solver_se(method.iteration, obj, maxinc, verbose)
            if maxinc < tolerance:
                converged = True
                break
            if method.iteration == iteration:
                break
            solve(analysis)
        residuals(analysis)
        print_residuals_se(method.residual, method.precision_diag, verbose)
        method.converged = converged
        vm, va = analysis._state()
        method.objective = float(_wls_objective(analysis.arrays,
                                                analysis.net, vm, va))
        print_exit("gauss_newton", converged, not converged,
                   method.iteration, verbose)
    else:
        vm0, va0 = analysis._state()
        solver = _se_solve_damped if damping else _se_solve
        with method.timings.span("solve"), default_timings.span("se.solve"):
            vm, va, it, maxinc, converged, relmax = solver(
                analysis.arrays, analysis.net, vm0, va0, tolerance,
                iteration, kind)
            if kind not in (linalg.QR, linalg.PW) and relmax > 1e-6 and \
                    analysis.arrays.pair_r1.shape[0] == 0:
                # the normal equations were not solved to a trustworthy
                # increment (a failed Cholesky, or cond(G) past ~1e10):
                # escalate to the square-root (QR) method, the reference's
                # own remedy for ill-conditioned normal equations
                # (acStateEstimation.jl:878-931 Orthogonal rationale)
                method.refine_escalated = True
                vm, va, it, maxinc, converged, relmax = solver(
                    analysis.arrays, analysis.net, vm0, va0, tolerance,
                    iteration, linalg.QR)
            analysis.voltage.magnitude = vm.cpu().numpy()
            analysis.voltage.angle = va.cpu().numpy()
        method.iteration = it
        method.converged = converged
        method.max_increment = maxinc
        method.refine_residual = relmax
        # the residuals of the state before this solve are stale: readers
        # (the meter tables) recompute them at the new state
        method.residual = None
        if verbose:
            from ..report.solver import print_exit
            print_exit("gauss_newton", converged, not converged, it,
                       verbose)

    if power:
        from ..postprocessing.ac import power as ac_power
        ac_power(analysis)
    if current:
        from ..postprocessing.ac import current as ac_current
        ac_current(analysis)
    return analysis


def residuals(analysis: AcStateEstimation):
    """Measurement residuals r = z - h(x) at the current state (host)."""
    analysis._refresh_arrays()
    vm, va = analysis._state()
    H, h = build_h(analysis.arrays, analysis.net, vm, va)
    mean = analysis.arrays.mean.cpu().numpy()
    r = mean - h.cpu().numpy()
    analysis.method.residual = r
    analysis.method.jacobian = H.cpu().numpy()
    analysis.method.precision_diag = analysis.arrays.w.cpu().numpy()
    analysis.method.mean = mean
    return r
