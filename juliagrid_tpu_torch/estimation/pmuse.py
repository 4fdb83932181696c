"""Linear PMU state estimation in rectangular coordinates, on PyTorch
tensors.

Port of ``juliagrid_tpu/estimation/pmuse.py`` (after JuliaGrid
src/stateEstimation/pmuStateEstimation.jl:42-177, the constructor: bus phasor
identity rows and branch current rows from the complex two-port row
[y_ff, y_ft] / [y_tf, y_tt]; :369-473, the WLS solves). The state is
(Re V, Im V) for every bus, with no slack handling: the angle reference
comes from the phasor measurements. Correlated PMUs contribute 2x2
precision blocks exactly as in the AC path (``acse._weighted``).

The host collects H as COO entries (``_pmuse_host``) and scatters them into
the dense f64 H on the analysis device, as ``dcse.py`` does. The solve is
one f64 gain ``HᵀWH`` (one ``torch.matmul``, the pair terms included) and
an LU, or a QR of ``W½H``. There is no iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..ops import equations as eq
from ..ops import linalg
from ..powerflow.ac import Polar
from ..system.model import model
from ..system.types import PowerSystem
from .acse import _weighted


class PmuSeArrays(NamedTuple):
    """Device snapshot of the PMU measurement model."""

    h_dense: torch.Tensor   # f64[2p, 2n]
    mean: torch.Tensor      # f64[2p]
    w: torch.Tensor         # f64[2p]
    pair_r1: torch.Tensor   # i64 correlated row pairs
    pair_r2: torch.Tensor
    pair_off: torch.Tensor  # f64 off-diagonal precision


class PmuSeHost(NamedTuple):
    """The PMU measurement rows on the host: H as COO entries."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: tuple            # (2p, 2n)
    mean: np.ndarray
    w: np.ndarray
    pair_r1: np.ndarray
    pair_r2: np.ndarray
    pair_off: np.ndarray
    inservice: int


@dataclass
class PmuSeMethod:
    name: str
    factorization: str = linalg.LU
    iteration: int = 0
    converged: bool = False
    inservice: int = 0
    residual: Optional[np.ndarray] = None
    #: the arrays' device H itself, not a host copy
    jacobian: Optional[torch.Tensor] = None
    precision_diag: Optional[np.ndarray] = None
    mean: Optional[np.ndarray] = None


@dataclass
class PmuStateEstimation:
    system: PowerSystem
    monitoring: object
    voltage: Polar
    method: PmuSeMethod
    arrays: PmuSeArrays
    device: torch.device
    power: Optional[object] = None
    current: Optional[object] = None
    kind: str = "state_estimation"
    signature: dict = field(default_factory=dict)

    def _refresh_arrays(self):
        rev = self.system.model.revision
        mrev = self.monitoring.revision
        sig = self.signature
        if (sig.get("ac_model") != rev.ac_model
                or sig.get("measurement") != mrev.measurement
                or sig.get("meas_values") != mrev.values):
            self.arrays, self.method.inservice = compile_pmuse_arrays(
                self.system, self.monitoring, device=self.device)
            sig.update(ac_model=rev.ac_model, measurement=mrev.measurement,
                       meas_values=mrev.values)


def _pmuse_host(system: PowerSystem, monitoring) -> PmuSeHost:
    """The rows of the JAX package's ``compile_pmuse_arrays`` (its
    :83-138), with H as COO entries: rows 2i and 2i+1 (real, imaginary)
    for PMU i, all-zero while the PMU is out of service."""
    model(system, "ac")
    n = system.bus.number
    ac = system.model.ac
    pmu = monitoring.pmu
    p = pmu.number

    rows, cols, vals = [], [], []
    mean = np.zeros(2 * p)
    w = np.zeros(2 * p)
    pair_r1, pair_r2, pair_off = [], [], []
    inservice = 0

    f = system.branch.layout.from_bus
    t = system.branch.layout.to_bus

    def put(r, c, v):
        rows.append(r)
        cols.append(c)
        vals.append(v)

    for i in range(p):
        k = int(pmu.layout.index[i])
        ang = pmu.angle.mean[i]
        mag = pmu.magnitude.mean[i]
        cos_t, sin_t = np.cos(ang), np.sin(ang)
        var_re, var_im = eq.variance_pmu(
            pmu.magnitude.variance[i], pmu.angle.variance[i],
            mag, cos_t, sin_t)
        r_re, r_im = 2 * i, 2 * i + 1
        if pmu.layout.correlated[i]:
            w11, w22, off = eq.covariance_pmu(
                pmu.magnitude.variance[i], pmu.angle.variance[i], mag,
                cos_t, sin_t, var_re, var_im)
            w[r_re], w[r_im] = w11, w22
            pair_r1.append(r_re)
            pair_r2.append(r_im)
            pair_off.append(off)
        else:
            w[r_re], w[r_im] = 1.0 / var_re, 1.0 / var_im

        if not (pmu.magnitude.status[i] == 1 and pmu.angle.status[i] == 1):
            continue
        inservice += 2
        mean[r_re] = mag * cos_t
        mean[r_im] = mag * sin_t

        if pmu.layout.bus[i]:
            put(r_re, k, 1.0)
            put(r_im, n + k, 1.0)
        else:
            fb, tb = int(f[k]), int(t[k])
            if pmu.layout.from_[i]:
                cf, ct = ac.nodal_from_from[k], ac.nodal_from_to[k]
            else:
                cf, ct = ac.nodal_to_from[k], ac.nodal_to_to[k]
            # ReI row:  Re(c) ReV - Im(c) ImV ; ImI row: Im(c) ReV + Re(c) ImV
            put(r_re, fb, cf.real)
            put(r_re, n + fb, -cf.imag)
            put(r_re, tb, ct.real)
            put(r_re, n + tb, -ct.imag)
            put(r_im, fb, cf.imag)
            put(r_im, n + fb, cf.real)
            put(r_im, tb, ct.imag)
            put(r_im, n + tb, ct.real)

    return PmuSeHost(
        rows=np.asarray(rows, dtype=np.int64),
        cols=np.asarray(cols, dtype=np.int64),
        vals=np.asarray(vals, dtype=np.float64), shape=(2 * p, 2 * n),
        mean=mean, w=w,
        pair_r1=np.asarray(pair_r1, dtype=np.int64),
        pair_r2=np.asarray(pair_r2, dtype=np.int64),
        pair_off=np.asarray(pair_off, dtype=np.float64),
        inservice=inservice)


def compile_pmuse_arrays(system: PowerSystem, monitoring, device=None):
    """``(PmuSeArrays, inservice)`` on ``device`` (default
    ``config.device``): the host rows of ``_pmuse_host`` with H scattered
    on the device."""
    # convert.py builds PmuSeArrays from numpy and imports this module
    from ..convert import pmuse_arrays_from_numpy

    dev = resolve_device(device)
    host = _pmuse_host(system, monitoring)
    arr = pmuse_arrays_from_numpy(
        h_dense=linalg.dense_from_coo(host.rows, host.cols, host.vals,
                                      host.shape, dev),
        mean=host.mean, w=host.w, pair_r1=host.pair_r1,
        pair_r2=host.pair_r2, pair_off=host.pair_off, device=dev)
    return arr, host.inservice


def _pmuse_normal_equations(arr: PmuSeArrays):
    """The gain ``HᵀWH`` (one matmul; W with the correlated 2x2 blocks) and
    the right-hand side ``HᵀWz``."""
    wh, wz = _weighted(arr, arr.h_dense, arr.mean)
    return arr.h_dense.mT @ wh, arr.h_dense.mT @ wz


def _pmuse_solve(arr: PmuSeArrays, kind: str):
    """Bus voltage magnitudes and angles: LU of the normal equations, or QR
    of ``W½H`` (diagonal weights)."""
    if kind == linalg.QR:
        sw = arr.w.sqrt()
        x = linalg.solve(linalg.factorize(sw[:, None] * arr.h_dense,
                                          linalg.QR), sw * arr.mean)
    else:
        gain, rhs = _pmuse_normal_equations(arr)
        x = linalg.solve(linalg.factorize(gain, linalg.LU), rhs)
    n = arr.h_dense.shape[1] // 2
    re, im = x[:n], x[n:]
    return torch.sqrt(re**2 + im**2), torch.atan2(im, re)


def _rect_state(vm: torch.Tensor, va: torch.Tensor) -> torch.Tensor:
    return torch.cat([vm * torch.cos(va), vm * torch.sin(va)])


def _pmu_residual(arr: PmuSeArrays, vm, va) -> torch.Tensor:
    """``r = z - Hx`` at the polar state, zero on the rows of PMUs out of
    service (all-zero rows of H)."""
    r = arr.mean - arr.h_dense @ _rect_state(vm, va)
    return torch.where(arr.h_dense.abs().sum(1) == 0, 0.0, r)


def pmu_state_estimation(monitoring, factorization: str = linalg.LU,
                         device=None) -> PmuStateEstimation:
    """Reference pmuStateEstimation (pmuStateEstimation.jl:42-70), on
    ``device`` (default ``config.device``)."""
    device = resolve_device(device)
    system = monitoring.system
    model(system, "ac")
    arr, inservice = compile_pmuse_arrays(system, monitoring, device=device)
    rev = system.model.revision
    method = PmuSeMethod("pmu_wls", factorization)
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


def pmu_se_solve(analysis: PmuStateEstimation, power: bool = False,
                 current: bool = False):
    """One PMU WLS solve (reference solve! for PMU state estimation)."""
    analysis._refresh_arrays()
    arr = analysis.arrays
    kind = linalg.QR if analysis.method.factorization == linalg.QR \
        else linalg.LU
    vm, va = _pmuse_solve(arr, kind)
    analysis.voltage.magnitude = vm.cpu().numpy()
    analysis.voltage.angle = va.cpu().numpy()
    method = analysis.method
    method.converged = True
    method.residual = (arr.mean - arr.h_dense @ _rect_state(vm, va)
                       ).cpu().numpy()
    method.jacobian = arr.h_dense
    method.precision_diag = arr.w.cpu().numpy()
    method.mean = arr.mean.cpu().numpy()
    if power:
        from ..postprocessing.ac import power as ac_power
        ac_power(analysis)
    if current:
        from ..postprocessing.ac import current as ac_current
        ac_current(analysis)
    return analysis
