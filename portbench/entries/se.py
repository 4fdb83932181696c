"""The state estimation fleet: one ``batched_se_solve`` a call.

The configuration's ``measurement`` gives the rule and variances of the
rows (``reference.grid.MeasurementSet``); their base means are the
reference's own power flow of the case. A mix's keys (``traffic/<mix>.json``,
besides ``entry``, ``scenarios``, ``tol``, ``max_iter`` and
``check_calls``):

- ``noise_sigmas``: each row's mean is its base value plus
  noise_sigmas * sigma * N(0, 1), sigma the row's standard deviation;
- ``start``: ``"setpoints"`` or ``"case"`` (the stored voltages: the
  estimator's start).
"""

from __future__ import annotations

import juliagrid_tpu_torch as jgt
import numpy as np
import torch
from juliagrid_tpu_torch.estimation.acse import gain_table
from juliagrid_tpu_torch.parallel import batched_se_solve

from portbench.check import REFERENCE_BYTES
from portbench.generator import start_state
from portbench.reference import grid as ref

#: the loop's last increment only tests convergence
EXTRA_SOLVES = 1


def prepare(case, config, device) -> dict:
    """The rows, their variances and base means (the reference's power
    flow of the case, measured)."""
    m = config["measurement"]
    meas = ref.MeasurementSet.every_bus_and_branch(case, m["pmu_every"],
                                                   m["variances"])
    grid = ref.Grid.build(case, device)
    vm, va, _, ok = ref.nr_solve(
        grid, torch.as_tensor(case.vm_start, device=device)[None],
        torch.as_tensor(case.va_case, device=device)[None],
        torch.as_tensor(case.p_sched, device=device)[None],
        torch.as_tensor(case.q_sched, device=device)[None])
    if not bool(ok.all()):
        raise RuntimeError("the reference's base power flow diverged")
    means = ref.measure(grid, meas, vm, va)[0].cpu().numpy()
    return dict(meas=meas, means=means, sigma=np.sqrt(meas.variance))


def base(params, case, prep, device) -> dict:
    vm0, va0 = start_state(params, case, device)
    return dict(vm0=vm0, va0=va0,
                means=torch.as_tensor(prep["means"], device=device)[None],
                sigma=torch.as_tensor(prep["sigma"], device=device)[None])


def draw(params, base, gen) -> dict:
    """One call's inputs from the generator ``gen``."""
    shape = (base["vm0"].shape[0], base["means"].shape[1])
    z = torch.randn(shape, generator=gen, dtype=torch.float64,
                    device=base["vm0"].device)
    return dict(vm0=base["vm0"], va0=base["va0"],
                means=base["means"] + params["noise_sigmas"]
                * base["sigma"] * z)


class Program:
    def __init__(self, arrays, net, tol, max_iter):
        self.arrays, self.net = arrays, net
        self.tol, self.max_iter = tol, max_iter

    def solve(self, inputs):
        """``(vm, va, iterations, converged)`` of one call."""
        return batched_se_solve(self.arrays, self.net, inputs["vm0"],
                                inputs["va0"], inputs["means"], tol=self.tol,
                                max_iter=self.max_iter)


def _measurement(system, meas, means):
    """The port's measurement set holding the benchmark's rows, in
    ``MeasurementSet``'s order."""
    mon = jgt.measurement(system)
    bus = system.bus.label.label
    branch = system.branch.label.label
    n, nb = system.bus.number, system.branch.number
    var = meas.variance
    row = 0
    for i in meas.volt_bus:
        jgt.add_voltmeter(mon, bus=bus(int(i)), magnitude=float(means[row]),
                          variance=float(var[row]))
        row += 1
    for add, key in ((jgt.add_wattmeter, "active"),
                     (jgt.add_varmeter, "reactive")):
        for i in range(n):
            add(mon, bus=bus(i), variance=float(var[row]),
                **{key: float(means[row])})
            row += 1
        for k in range(nb):
            if system.branch.layout.status[k] != 1:
                continue
            for end in ("from_branch", "to_branch"):
                add(mon, variance=float(var[row]),
                    **{end: branch(k), key: float(means[row])})
                row += 1
    for i in meas.pmu_bus:
        jgt.add_pmu(mon, bus=bus(int(i)), magnitude=float(means[row]),
                    angle=float(means[row + 1]),
                    variance_magnitude=float(var[row]),
                    variance_angle=float(var[row + 1]), polar=True)
        row += 2
    return mon


def build(case_path, params, device, prep) -> Program:
    """The port's estimator of the case at ``case_path`` over the
    benchmark's rows, given through the measurement layer with explicit
    means and variances, and K8's gain table."""
    system = jgt.power_system(str(case_path))
    mon = _measurement(system, prep["meas"], prep["means"])
    se = jgt.gauss_newton(mon, device=device)
    gain_table(se.arrays, se.net)
    return Program(se.arrays, se.net, params["tol"], params["max_iter"])


def chunk(case, prep) -> int:
    """Scenarios the reference holds at once: its dense H over m rows and
    2n columns with the weighted copy and the column selection (~48 m n
    bytes a scenario) and the injections' n x n blocks (~32 n²), within
    ``REFERENCE_BYTES``."""
    rows = prep["meas"].rows
    return max(1, REFERENCE_BYTES // (48 * rows * case.n + 32 * case.n ** 2))


def reference_solve(grid, prep, params, inputs, chunk):
    return ref.se_solve(grid, prep["meas"], inputs["vm0"], inputs["va0"],
                        inputs["means"], tol=params["tol"],
                        max_iter=params["max_iter"], chunk=chunk)


def h_pattern(case, meas):
    """H's structural entries over the states (the angles but the slack's,
    then the magnitudes): each row's state columns, as CSR row pointers
    and column indices, rows in ``MeasurementSet``'s order."""
    n = case.n
    yr, yc = case.pattern()
    inj = np.split(yc, np.searchsorted(yr, np.arange(1, n)))
    inj = [np.concatenate([c, n + c]) for c in inj]
    ends = [np.array([f, t, n + f, n + t]) for f, t in zip(case.f, case.t)
            for _ in range(2)]
    rows = [np.array([n + i]) for i in meas.volt_bus]
    rows += inj + ends + inj + ends
    for i in meas.pmu_bus:
        rows += [np.array([n + i]), np.array([i])]
    rows = [c[c != case.slack] for c in rows]
    cols = np.concatenate(rows)
    cols = cols - (cols > case.slack)
    ptr = np.concatenate([[0], np.cumsum([len(c) for c in rows])])
    return ptr, cols


def shape(case, prep) -> dict:
    """Sizes the roofline counts take: the states, rows, H's structural
    entries over the states, the gain's structural entries on and below
    its diagonal (``gain_lower``: pairs of a row's entries, joined over
    rows) and the products they sum (``pairs``: w(w + 1)/2 a row of w
    entries)."""
    ptr, cols = h_pattern(case, prep["meas"])
    states = 2 * case.n - 1
    width = np.diff(ptr)
    row_of = np.repeat(np.arange(len(width)), width)
    first = np.repeat(np.arange(len(cols)), width[row_of])
    within = np.arange(len(first)) - np.repeat(
        np.cumsum(width[row_of]) - width[row_of], width[row_of])
    second = ptr[row_of[first]] + within
    hi = np.maximum(cols[first], cols[second])
    lo = np.minimum(cols[first], cols[second])
    gain_lower = len(np.unique(hi * states + lo))
    return dict(n=case.n, nnz=case.pattern_nnz(), branches=len(case.f),
                states=states, rows=int(len(width)), entries=int(len(cols)),
                gain_lower=int(gain_lower),
                pairs=int((width * (width + 1) // 2).sum()),
                extra_solves=EXTRA_SOLVES)
