"""Power-flow driver (reference powerFlow!, acPowerFlow.jl:1389-1433 and
dcPowerFlow.jl:159-178).

Dispatches on the analysis: an AC or DC OPF analysis runs the interior
point (``opf.solve_opf``); a DC analysis is one masked solve
(``dc.dc_solve``); an AC analysis runs its method's loop on the device with
one scalar-pair readback per iteration (``ac._nr_solve``,
``fast_decoupled._fnr_solve``, ``gauss_seidel._gs_solve``). Iteration
semantics match the reference exactly: the count equals the number of
iterations performed, and convergence is judged on the freshly recomputed
mismatches.

A Newton-Raphson call is the profiler range ``jgt.power_flow``
(``utils.profiling.annotate``) holding its stages: ``refresh`` (the device
arrays brought up to the system's revision, ``AcPowerFlow._refresh_arrays``,
whose rebuilds ``default_timings`` counts as ``pf.rebuild``), then
``_nr_solve``'s ``fill``, ``test`` and ``solve``. With no profiler
recording they cost a few flag tests.
"""

from __future__ import annotations

import numpy as np

from ..config import config
from ..report.solver import (print_exit, print_increments_pf,
                             print_middle_pf, print_solver_pf, print_top)
from ..utils.profiling import annotate, default_timings, mark
from .ac import FAST_DECOUPLED, AcPowerFlow, _nr_solve
from .dc import DcPowerFlow, dc_solve


def power_flow(analysis, iteration: int = 20, tolerance: float = 1e-8,
               power: bool = False, current: bool = False,
               verbose: int | None = None):
    """Solve a power-flow analysis to convergence."""
    from ..opf.acopf import AcOptimalPowerFlow
    from ..opf.dcopf import DcOptimalPowerFlow
    if isinstance(analysis, (AcOptimalPowerFlow, DcOptimalPowerFlow)):
        # reference powerFlow! also wraps OPF analyses
        from ..opf import solve_opf
        solve_opf(analysis, verbose=verbose or 0)
        if power and isinstance(analysis, AcOptimalPowerFlow):
            from ..postprocessing.ac import power as ac_power
            ac_power(analysis)
        elif power:
            from ..postprocessing.dc import power as dc_power
            dc_power(analysis)
        if current and isinstance(analysis, AcOptimalPowerFlow):
            from ..postprocessing.ac import current as ac_current
            ac_current(analysis)
        return analysis
    if isinstance(analysis, DcPowerFlow):
        dc_solve(analysis, verbose=verbose)
        if power:
            from ..postprocessing.dc import power as dc_power
            dc_power(analysis)
        return analysis
    if not isinstance(analysis, AcPowerFlow):
        raise NotImplementedError(
            "power_flow runs Newton-Raphson, fast decoupled, Gauss-Seidel, "
            f"DC, DC OPF and AC OPF analyses; {type(analysis).__name__} is "
            "none of them")

    verbose = config.verbose if verbose is None else verbose
    if analysis.method.name != "newton_raphson":
        return _ac_power_flow(analysis, iteration, tolerance, power, current,
                              verbose, stages=False)
    with annotate("jgt.power_flow"):
        try:
            return _ac_power_flow(analysis, iteration, tolerance, power,
                                  current, verbose, stages=True)
        finally:
            mark(None)


def _ac_power_flow(analysis, iteration, tolerance, power, current, verbose,
                   stages):
    """The AC methods' driver; with ``stages`` the array refresh is the
    stage ``refresh`` (``utils.profiling.mark``)."""
    method = analysis.method
    if stages:
        mark("refresh")
    with method.timings.span("refresh"), default_timings.span("pf.refresh"):
        analysis._refresh_arrays()
    if stages:
        mark(None)
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
        if dmag is not None and method.name != "gauss_seidel":
            print_increments_pf((float(dmag.min()), float(dmag.max())),
                                (float(dang.min()), float(dang.max())),
                                verbose)
        method.converged = converged
        print_exit(method.name, converged, not converged,
                   method.iteration, verbose)
    else:
        vm, va = analysis._state()
        with method.timings.span("solve"), default_timings.span("pf.solve"):
            if method.name == "newton_raphson":
                vm, va, it, del_p, del_q, converged = _nr_solve(
                    analysis.arrays, vm, va, tolerance, iteration,
                    method.factorization)
            elif method.name in FAST_DECOUPLED:
                from .fast_decoupled import _fnr_solve
                vm, va, it, del_p, del_q, converged = _fnr_solve(
                    analysis.arrays, vm, va, tolerance, iteration,
                    method.factorization)
            elif method.name == "gauss_seidel":
                from .gauss_seidel import _gs_solve
                vm, va, it, del_p, del_q, converged = _gs_solve(
                    analysis.arrays, vm, va, tolerance, iteration)
            else:
                raise ValueError(f"unknown method {method.name}")
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
