"""Power-flow driver (reference powerFlow!, acPowerFlow.jl:1389-1433).

Newton-Raphson only. The mismatch/solve loop runs on the device with one
scalar-pair readback per iteration (``ac._nr_solve``); iteration semantics
match the reference exactly: the count equals the number of linear solves
performed, and convergence is judged on the freshly recomputed mismatches.
"""

from __future__ import annotations

import numpy as np

from ..config import config
from ..report.solver import (print_exit, print_increments_pf,
                             print_middle_pf, print_solver_pf, print_top)
from ..utils.profiling import default_timings
from .ac import AcPowerFlow, _nr_solve


def power_flow(analysis, iteration: int = 20, tolerance: float = 1e-8,
               power: bool = False, current: bool = False,
               verbose: int | None = None):
    """Solve a Newton-Raphson analysis to convergence."""
    if not isinstance(analysis, AcPowerFlow):
        raise NotImplementedError(
            f"power_flow runs Newton-Raphson analyses only; "
            f"{type(analysis).__name__} is not ported yet (ROADMAP items "
            "5 and 12)")

    verbose = config.verbose if verbose is None else verbose
    method = analysis.method
    with method.timings.span("refresh"), default_timings.span("pf.refresh"):
        analysis._refresh_arrays()
    method.iteration = 0

    if verbose >= 2:
        # reference-style statistics + per-iteration log (print/solver.jl):
        # run the stepwise host loop so each mismatch can be reported
        from .ac import mismatch as _mismatch_step
        from .ac import solve as _solve_step
        print_top(analysis.system, analysis, verbose)
        print_middle_pf(analysis.system, analysis, verbose)
        converged = False
        dmag = dang = None
        for _ in range(iteration + 1):
            del_p, del_q = _mismatch_step(analysis)
            print_solver_pf(method.iteration, del_p, del_q, verbose)
            if del_p < tolerance and del_q < tolerance:
                converged = True
                break
            if method.iteration == iteration:
                break
            vm_prev = np.asarray(analysis.voltage.magnitude).copy()
            va_prev = np.asarray(analysis.voltage.angle).copy()
            _solve_step(analysis)
            dmag = np.abs(np.asarray(analysis.voltage.magnitude) - vm_prev)
            dang = np.abs(np.asarray(analysis.voltage.angle) - va_prev)
        if dmag is not None:
            print_increments_pf((float(dmag.min()), float(dmag.max())),
                                (float(dang.min()), float(dang.max())),
                                verbose)
        method.converged = converged
        print_exit(method.name, converged, not converged,
                   method.iteration, verbose)
    else:
        vm, va = analysis._state()
        with method.timings.span("solve"), default_timings.span("pf.solve"):
            vm, va, it, del_p, del_q, converged = _nr_solve(
                analysis.arrays, vm, va, tolerance, iteration,
                method.factorization)
            analysis.voltage.magnitude = vm.cpu().numpy()
            analysis.voltage.angle = va.cpu().numpy()
        method.iteration = it
        method.converged = converged
        method.max_mismatch_active = del_p
        method.max_mismatch_reactive = del_q
        if verbose:
            print_exit(method.name, method.converged, not method.converged,
                       method.iteration, verbose)

    if power:
        from ..postprocessing.ac import power as ac_power
        ac_power(analysis)
    if current:
        from ..postprocessing.ac import current as ac_current
        ac_current(analysis)
    return analysis
