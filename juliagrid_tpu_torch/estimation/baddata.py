"""Bad-data processing: chi-squared test and largest normalized residual,
on PyTorch tensors.

Port of ``juliagrid_tpu/estimation/baddata.py`` (after JuliaGrid
src/stateEstimation/badData.jl). The normalized residual of row i is
|r_i| / sqrt(|R_ii - c_i|), with ``c = diag(H G⁻¹ Hᵀ)`` and G = HᵀWH. The
dense path (``_projection_diag``) computes c on the analysis device from one
f64 Cholesky G = LLᵀ and one triangular solve, c_i = ‖L⁻¹h_i‖²; at scale the
host path takes the Takahashi selected inverse (``takahashi.py``, the
reference's :536-911). The worst device above the threshold is set out of
service (:48-285). ``chi_test`` (:948-995) compares the WLS objective with
the chi-squared quantile at the given confidence, with the reference's
degrees of freedom per analysis.

``lnr_removal`` is the JAX package's fused detect-remove-resolve loop as a
host loop over tensors: Gauss-Newton from the current state (one K3 launch
and one scalar readback per iteration), then one K3 launch for H and h, the
dense projection, and one readback of the worst row and its normalized
residual; the worst device's rows leave together through the ``status``
tensor K3 reads, so the descriptor table is never rebuilt.

Three behaviours differ from the JAX package, which is at fault in each
(ROADMAP queue 3): ``lnr_removal`` reports ``converged`` from its final
solve; it refuses, naming the stepwise loop, a dense H and G⁻¹Hᵀ the device
cannot hold; and the DC residuals are ``z - H(θ - θ_slack)`` in every
function, as in ``dc_se_solve``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.stats
import torch


@dataclass
class ResidualTest:
    detect: bool = False
    max_normalized_residual: float = 0.0
    label: object = None
    index: int = -1


@dataclass
class ChiTest:
    detect: bool
    treshold: float   # reference field name (sic)
    objective: float


def _projection_diag(h: torch.Tensor, w: torch.Tensor,
                     mask_cols=None) -> torch.Tensor:
    """c = diag(H G⁻¹ Hᵀ) with G = HᵀWH (+ identity on the masked columns,
    which H loses) for a dense f64 ``h [m, n]`` and ``w [m]`` on one
    device: c_i = ‖L⁻¹h_i‖² from the Cholesky factor L of G. Raises when G
    is not positive definite (the rows do not make the state
    observable)."""
    if mask_cols is not None:
        mask = torch.ones(h.shape[1], dtype=h.dtype, device=h.device)
        mask[list(mask_cols)] = 0.0
        h = h * mask
    a = h * w.sqrt()[:, None]
    gain = a.mT @ a
    del a
    if mask_cols is not None:
        gain.diagonal().add_(1.0 - mask)
    chol, info = torch.linalg.cholesky_ex(gain)
    del gain
    if int(info) != 0:
        raise ValueError("the gain HᵀWH is not positive definite: the "
                         "measurement rows do not make the state observable")
    x = torch.linalg.solve_triangular(chol, h.mT, upper=False)
    return x.square().sum(0)


def _find_worst(residual, w, c):
    """Largest normalized residual over rows with nonzero residual (host,
    numpy: the first index on ties)."""
    denom = np.sqrt(np.abs(1.0 / np.asarray(w) - np.asarray(c)))
    rn = np.where(residual != 0.0,
                  np.abs(residual) / np.maximum(denom, 1e-30), 0.0)
    idx = int(np.argmax(rn))
    return idx, float(rn[idx])


def _deactivate(monitoring, kind: str, device_idx: int):
    """Set one device out of service AND bump the measurement revision —
    without the bump the live analysis' signature check keeps the stale
    row snapshot and the LNR loop re-detects the same outlier forever."""
    label = _deactivate_raw(monitoring, kind, device_idx)
    monitoring.changed_values()
    return label


def _deactivate_raw(monitoring, kind: str, device_idx: int):
    if kind == "voltmeter":
        monitoring.voltmeter.magnitude.status[device_idx] = 0
        return monitoring.voltmeter.label.label(device_idx)
    if kind == "ammeter":
        monitoring.ammeter.magnitude.status[device_idx] = 0
        return monitoring.ammeter.label.label(device_idx)
    if kind == "wattmeter":
        monitoring.wattmeter.active.status[device_idx] = 0
        return monitoring.wattmeter.label.label(device_idx)
    if kind == "varmeter":
        monitoring.varmeter.reactive.status[device_idx] = 0
        return monitoring.varmeter.label.label(device_idx)
    if kind == "pmu":
        monitoring.pmu.magnitude.status[device_idx] = 0
        monitoring.pmu.angle.status[device_idx] = 0
        return monitoring.pmu.label.label(device_idx)
    raise ValueError(kind)


def _host_csr(h: torch.Tensor) -> sp.csr_matrix:
    """The scipy CSR copy of a dense tensor, compressed on its device."""
    s = h.to_sparse()
    rows, cols = s.indices().cpu().numpy()
    return sp.csr_matrix((s.values().cpu().numpy(), (rows, cols)),
                         shape=h.shape)


def _linear_state(analysis):
    """The solved state of a DC or PMU analysis as tensors on its
    device."""
    dev = analysis.device
    if hasattr(analysis.voltage, "magnitude"):
        return tuple(torch.as_tensor(np.asarray(x, dtype=float), device=dev)
                     for x in (analysis.voltage.magnitude,
                               analysis.voltage.angle))
    return torch.as_tensor(np.asarray(analysis.voltage.angle, dtype=float),
                           device=dev)


def _rows_and_residuals(analysis):
    """``(H, r, w, mask_cols, row_device)`` of an analysis, tensors on its
    device: H with the slack column kept, r with inactive rows zero.
    ``row_device`` maps a row to its (kind, device index)."""
    from .acse import AcStateEstimation, build_h
    from .dcse import DcStateEstimation, _dc_residual
    from .pmuse import PmuStateEstimation, _pmu_residual

    if isinstance(analysis, AcStateEstimation):
        analysis._refresh_arrays()
        arr = analysis.arrays
        h, hx = build_h(arr, analysis.net, *analysis._state())
        r = arr.mean - hx
        method = analysis.method
        method.residual = r.cpu().numpy()
        method.precision_diag = arr.w.cpu().numpy()
        method.mean = arr.mean.cpu().numpy()
        return (h, r * arr.status, arr.w, [arr.slack],
                method.row_device.__getitem__)
    if isinstance(analysis, DcStateEstimation):
        arr = analysis.arrays
        return (arr.h_dense, _dc_residual(arr, _linear_state(analysis)),
                arr.w, [arr.slack], analysis.method.row_device.__getitem__)
    if isinstance(analysis, PmuStateEstimation):
        arr = analysis.arrays
        return (arr.h_dense, _pmu_residual(arr, *_linear_state(analysis)),
                arr.w, None, lambda row: ("pmu", row // 2))
    raise TypeError(f"unsupported analysis {type(analysis)}")


def residual_test(analysis, threshold: float = 3.0,
                  sparse: bool | None = None) -> ResidualTest:
    """Reference residualTest! — dispatches on the analysis type (AC, DC,
    PMU).

    ``sparse`` selects the host Takahashi selected-inverse path for the
    residual-covariance diagonal; by default it runs for AC analyses with
    more than 1,500 state variables, as in the JAX package, and the dense
    projection on the analysis device otherwise."""
    from .acse import AcStateEstimation
    from .takahashi import projection_diag_sparse

    h, r, w, mask_cols, row_device = _rows_and_residuals(analysis)
    if sparse is None:
        sparse = isinstance(analysis, AcStateEstimation) and h.shape[1] > 1500
    w_host = w.cpu().numpy()
    if sparse:
        c = projection_diag_sparse(_host_csr(h), w_host, mask_cols=mask_cols)
    else:
        c = _projection_diag(h, w, mask_cols).cpu().numpy()
    idx, rn = _find_worst(r.cpu().numpy(), w_host, c)
    kind, dev = row_device(idx)

    bad = ResidualTest(max_normalized_residual=rn, index=idx)
    monitoring = analysis.monitoring
    if rn > threshold:
        bad.detect = True
        bad.label = _deactivate(monitoring, kind, dev)
    else:
        bad.label = getattr(monitoring, kind).label.label(dev)
    return bad


def _free_bytes(device: torch.device) -> int:
    """Bytes free on ``device``: the CUDA allocator's view of the card, or
    the host's available physical memory."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _lnr_detect(arr, net, vm, va):
    """The worst normalized residual over live rows with ``r ≠ 0``: one K3
    launch, the dense projection and one readback. Returns ``(row, rn)``."""
    from .acse import build_h

    h, hx = build_h(arr, net, vm, va)
    r = (arr.mean - hx) * arr.status
    c = _projection_diag(h, arr.w, [arr.slack])
    del h
    denom = torch.sqrt(torch.abs(1.0 / arr.w - c))
    rn = torch.where((r != 0.0) & (arr.status > 0.0),
                     r.abs() / denom.clamp(min=1e-30), 0.0)
    idx = torch.argmax(rn)
    row, value = torch.stack([idx.to(rn.dtype), rn[idx]]).tolist()
    return int(row), value


def lnr_removal(analysis, threshold: float = 3.0, max_remove: int = 10,
                tolerance: float = 1e-8, max_iter: int = 40):
    """Largest-normalized-residual correction for AC WLS state estimation.

    Equivalent to the reference usage pattern of calling ``residualTest!``
    + ``stateEstimation!`` in a loop (badData.jl:48-285) until no outlier
    remains, as one host loop over device tensors: solve, detect, drop the
    worst device's rows, re-solve warm, at most ``max_remove`` times, and a
    final solve of the surviving set. Deactivates the flagged devices in the
    monitoring set, leaves ``analysis`` solved on the surviving rows, with
    ``method.converged`` from the final solve, and returns the removed
    device labels in removal order.

    Each detection holds a dense H and G⁻¹Hᵀ: about ``3·m·2n·8`` bytes. Above
    the device's free memory this raises before it starts; the stepwise
    loop ``residual_test(analysis, sparse=True)`` + ``state_estimation``
    does the same work through the host Takahashi path."""
    from ..ops import linalg
    from .acse import AcStateEstimation, _se_solve

    if not isinstance(analysis, AcStateEstimation):
        raise TypeError("lnr_removal supports AC WLS state estimation")
    analysis._refresh_arrays()
    arr, net = analysis.arrays, analysis.net
    n = analysis.system.bus.number
    need = 3 * arr.mean.shape[0] * 2 * n * 8
    free = _free_bytes(analysis.device)
    if need > free:
        raise MemoryError(
            f"lnr_removal would hold about {need / 1e9:.2f} GB of dense H "
            f"and G⁻¹Hᵀ, {free / 1e9:.2f} GB are free on {analysis.device}; "
            "run the stepwise loop instead: residual_test(analysis, "
            "sparse=True), then state_estimation(analysis), until it detects "
            "nothing")
    # rows of one physical device share a group id, so that a detection
    # removes the whole device (both PMU rows), as _deactivate does
    groups = {}
    row_group = torch.tensor(
        [groups.setdefault(kd, len(groups))
         for kd in analysis.method.row_device], device=analysis.device)
    vm, va = analysis._state()
    status = arr.status
    removed = []
    while True:
        live = arr._replace(status=status)
        vm, va = _se_solve(live, net, vm, va, tolerance, max_iter,
                           linalg.LU)[:2]
        row, rn = _lnr_detect(live, net, vm, va)
        if not rn > threshold:
            break
        status = status * (row_group != row_group[row])
        removed.append(row)
        if len(removed) >= max_remove:
            break
    # the loop may stop on the cap with the last removal unsolved; this
    # solve (no iteration otherwise) leaves the state on the surviving set
    vm, va, _, _, converged, _ = _se_solve(
        arr._replace(status=status), net, vm, va, tolerance, max_iter,
        linalg.LU)
    labels = [_deactivate_raw(analysis.monitoring,
                              *analysis.method.row_device[row])
              for row in removed]
    if labels:
        analysis.monitoring.changed_values()
        # the loop already solved on the surviving set; absorb the revision
        # bump so the next _refresh_arrays keeps this snapshot
        analysis._refresh_arrays()
    analysis.voltage.magnitude = vm.cpu().numpy()
    analysis.voltage.angle = va.cpu().numpy()
    analysis.method.converged = converged
    return labels


def chi_test(analysis, confidence: float = 0.95) -> ChiTest:
    """Reference chiTest (badData.jl:948-995)."""
    from .acse import AcStateEstimation
    from .dcse import DcStateEstimation
    from .pmuse import PmuStateEstimation

    n = analysis.system.bus.number
    if isinstance(analysis, AcStateEstimation):
        from ..kernels.se_fill import se_fill
        analysis._refresh_arrays()
        arr = analysis.arrays
        vm, va = analysis._state()
        r = se_fill(arr, analysis.net, vm[None], va[None], arr.mean[None],
                    jacobian=False).r[0] * arr.status
        objective = torch.sum(r * r * arr.w)
        if arr.pair_r1.shape[0]:
            objective = objective + torch.sum(
                2 * r[arr.pair_r1] * r[arr.pair_r2] * arr.pair_off)
        objective, inservice = torch.stack(
            [objective, arr.status.sum()]).tolist()
        df = int(inservice) - 2 * n + 1
    elif isinstance(analysis, (DcStateEstimation, PmuStateEstimation)):
        _, r, w, _, _ = _rows_and_residuals(analysis)
        objective = float(torch.sum(r * r * w))
        df = analysis.method.inservice - (
            n - 1 if isinstance(analysis, DcStateEstimation) else 2 * n)
    else:
        raise TypeError(f"unsupported analysis {type(analysis)}")

    chi = float(scipy.stats.chi2.ppf(confidence, max(df, 1)))
    return ChiTest(objective >= chi, chi, objective)
