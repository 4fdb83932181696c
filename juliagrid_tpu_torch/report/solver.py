"""Solver progress printing — the reference's verbose 0-3 surface
(print/solver.jl:2-497): network statistics (verbose 3), model statistics
(verbose 2+), per-iteration solver tables with re-printed headers every 10
rows, min/max increment summaries, and per-method EXIT lines.
"""

from __future__ import annotations

import sys

import numpy as np

METHOD_NAMES = {
    "newton_raphson": "Newton-Raphson",
    "newton_raphson_bbd": "Newton-Raphson",
    "fast_newton_raphson_bx": "fast Newton-Raphson",
    "fast_newton_raphson_xb": "fast Newton-Raphson",
    "fast_newton_raphson_bbd_bx": "fast Newton-Raphson",
    "fast_newton_raphson_bbd_xb": "fast Newton-Raphson",
    "gauss_seidel": "Gauss-Seidel",
    "gauss_newton": "Gauss-Newton",
    "gauss_newton_bbd": "Gauss-Newton",
}


def _out(file):
    return file or sys.stdout


# ---------------------------------------------------------------------------
# verbose == 3: network / measurement statistics (printTop)
# ---------------------------------------------------------------------------

def print_top(system, analysis=None, verbose: int = 0, file=None):
    """Reference printTop (solver.jl:2-96): network statistics block."""
    if verbose != 3:
        return
    f = _out(file)
    bus, brc, gen = system.bus, system.branch, system.generator
    n = bus.number

    gsh = bus.shunt.conductance.array[:n]
    bsh = bus.shunt.susceptance.array[:n]
    has_shunt = (gsh != 0.0) | (bsh != 0.0)
    shunt = int(has_shunt.sum())
    capacitor = int(((bsh > 0.0) & has_shunt).sum())
    reactor = int(((bsh < 0.0) & has_shunt).sum())

    m = brc.number
    tr = ((brc.parameter.turns_ratio.array[:m] != 1.0)
          | (brc.parameter.shift_angle.array[:m] != 0.0))
    on = brc.layout.status.array[:m] == 1
    transformer = int(tr.sum())
    tr_in = int((tr & on).sum())
    tr_out = transformer - tr_in
    brc_in = int(on.sum())

    pq = int((bus.layout.type.array[:n] == 1).sum())
    gen_in = int((gen.layout.status.array[:gen.number] == 1).sum())

    c1 = max(len(str(n)), len(str(m)))
    c2 = max(len(str(shunt)), len(str(m - transformer)))
    c3 = max(len(str(gen.number)), len(str(transformer)))

    print(f"Number of buses:    {n:>{c1}}   Number of shunts: "
          f"{shunt:>{c2}}   Number of generators:   "
          f"{gen.number:>{c3}}", file=f)
    print(f"  Demand:           {pq:>{c1}}     Capacitor:      "
          f"{capacitor:>{c2}}     In-service:           "
          f"{gen_in:>{c3}}", file=f)
    print(f"  Generator:        {n - 1 - pq:>{c1}}     Reactor:        "
          f"{reactor:>{c2}}     Out-of-service:       "
          f"{gen.number - gen_in:>{c3}}\n", file=f)
    print(f"Number of branches: {m:>{c1}}   Number of lines:  "
          f"{m - transformer:>{c2}}   Number of transformers: "
          f"{transformer:>{c3}}", file=f)
    print(f"  In-service:       {brc_in:>{c1}}     In-service:     "
          f"{brc_in - tr_in:>{c2}}     In-service:           "
          f"{tr_in:>{c3}}", file=f)
    print(f"  Out-of-service:   {m - brc_in:>{c1}}     Out-of-service: "
          f"{m - brc_in - tr_out:>{c2}}     Out-of-service:       "
          f"{tr_out:>{c3}}\n", file=f)


def print_top_se(monitoring, verbose: int = 0, file=None):
    """Reference printTop for state estimation (solver.jl:115-194)."""
    if verbose != 3:
        return
    f = _out(file)
    mtg = monitoring
    dev = (mtg.voltmeter.number + mtg.ammeter.number + mtg.wattmeter.number
           + mtg.varmeter.number + mtg.pmu.number)
    volo = int((mtg.voltmeter.magnitude.status.array[
        :mtg.voltmeter.number] == 0).sum())
    ampo = int((mtg.ammeter.magnitude.status.array[
        :mtg.ammeter.number] == 0).sum())
    wato = int((mtg.wattmeter.active.status.array[
        :mtg.wattmeter.number] == 0).sum())
    varo = int((mtg.varmeter.reactive.status.array[
        :mtg.varmeter.number] == 0).sum())
    npmu = mtg.pmu.number
    pmuo = int(((mtg.pmu.magnitude.status.array[:npmu] == 0)
                | (mtg.pmu.angle.status.array[:npmu] == 0)).sum())

    c1 = max(len(str(mtg.wattmeter.number)), len(str(mtg.ammeter.number)))
    c2 = max(len(str(mtg.varmeter.number)), len(str(npmu)))
    c3 = max(len(str(mtg.voltmeter.number)), len(str(dev)))

    print(f"Number of wattmeters: {mtg.wattmeter.number:>{c1}}   "
          f"Number of varmeters: {mtg.varmeter.number:>{c2}}   "
          f"Number of voltmeters: {mtg.voltmeter.number:>{c3}}", file=f)
    print(f"  In-service:         {mtg.wattmeter.number - wato:>{c1}}     "
          f"In-service:        {mtg.varmeter.number - varo:>{c2}}     "
          f"In-service:         {mtg.voltmeter.number - volo:>{c3}}",
          file=f)
    print(f"  Out-of-service:     {wato:>{c1}}     "
          f"Out-of-service:    {varo:>{c2}}     "
          f"Out-of-service:     {volo:>{c3}}\n", file=f)
    print(f"Number of ammeters:   {mtg.ammeter.number:>{c1}}   "
          f"Number of PMUs:      {npmu:>{c2}}   "
          f"Number of devices:    {dev:>{c3}}", file=f)
    print(f"  In-service:         {mtg.ammeter.number - ampo:>{c1}}     "
          f"In-service:        {npmu - pmuo:>{c2}}     "
          f"In-service:         "
          f"{dev - volo - ampo - wato - varo - pmuo:>{c3}}", file=f)
    print(f"  Out-of-service:     {ampo:>{c1}}     "
          f"Out-of-service:    {pmuo:>{c2}}     "
          f"Out-of-service:     "
          f"{volo + ampo + wato + varo + pmuo:>{c3}}\n", file=f)


# ---------------------------------------------------------------------------
# verbose >= 2: model statistics (printMiddle)
# ---------------------------------------------------------------------------

def _stats_block(rows, file=None):
    """Right-aligned number column after the longest message."""
    f = _out(file)
    wd = max(len(msg) for msg, _ in rows)
    num = max(len(str(v)) for _, v in rows) + 1
    for msg, val in rows:
        print(f"{msg}{val:>{wd - len(msg) + num}}", file=f)
    print(file=f)


def print_middle_pf(system, analysis, verbose: int = 0, file=None):
    """Reference printMiddle (solver.jl:195-271): model statistics."""
    if verbose not in (2, 3):
        return
    n = system.bus.number
    name = analysis.method.name
    types = system.bus.layout.type.array[:n]
    pq = int((types == 1).sum())
    if name.startswith("newton_raphson"):
        nnz_y = system.model.ac.nodal.nnz
        _stats_block([
            ("Number of entries in the Jacobian:", 4 * nnz_y),
            ("Number of state variables:", n - 1 + pq)], file)
    elif name.startswith("fast_newton_raphson"):
        nnz_y = system.model.ac.nodal.nnz
        _stats_block([
            ("Number of entries in the Jacobians:", 2 * nnz_y),
            ("  Active Power:", nnz_y),
            ("  Reactive Power:", nnz_y),
            ("Number of state variables:", n - 1 + pq)], file)
    elif name == "gauss_seidel":
        pv = n - 1 - pq
        _stats_block([
            ("Number of complex state variables:", pq + pv),
            ("Number of complex equations:", pq + 3 * pv)], file)
    elif name == "dc_power_flow":
        _stats_block([
            ("Number of entries in the nodal matrix:",
             system.model.dc.nodal.nnz),
            ("Number of state variables:", n - 1)], file)


def print_middle_se(system, analysis, verbose: int = 0, file=None):
    """Reference printMiddle for estimation (solver.jl:273-335)."""
    if verbose not in (2, 3):
        return
    n = system.bus.number
    rows_n = int(analysis.arrays.mean.shape[0])
    ent = int(np.count_nonzero(
        np.asarray(analysis.method.jacobian))) if (
        analysis.method.jacobian is not None) else "n/a"
    _stats_block([
        ("Number of entries in the Jacobian:", ent),
        ("Number of measurement functions:", rows_n),
        ("Number of state variables:", 2 * n - 1),
        ("Number of buses:", n),
        ("Number of branches:", system.branch.number)], file)


# ---------------------------------------------------------------------------
# verbose >= 2: per-iteration solver tables (printSolver)
# ---------------------------------------------------------------------------

def print_solver_pf(iteration: int, del_p: float, del_q: float,
                    verbose: int = 0, file=None):
    """Reference printSolver for AC PF (solver.jl:337-348)."""
    if verbose not in (2, 3):
        return
    f = _out(file)
    if iteration % 10 == 0:
        print("-" * 63, file=f)
        print("Iteration   Maximum Active Mismatch   Maximum Reactive "
              "Mismatch", file=f)
        print("-" * 63, file=f)
    print(f"{iteration:>9} {del_p:>25.8e}{del_q:>28.8e}", file=f)


def print_increments_pf(mag_minmax, ang_minmax, verbose: int = 0, file=None):
    """Reference printSolver end block (solver.jl:350-371)."""
    if verbose not in (2, 3):
        return
    f = _out(file)
    print(file=f)
    print(" " * 23 + "Minimum Value   Maximum Value", file=f)
    print(f"Magnitude Increment:{mag_minmax[0]:>16.4e}"
          f"{mag_minmax[1]:>16.4e}", file=f)
    print(f"Angle Increment:{ang_minmax[0]:>20.4e}"
          f"{ang_minmax[1]:>16.4e}\n", file=f)


def print_solver_se(iteration: int, objective: float, increment: float,
                    verbose: int = 0, file=None):
    """Reference printSolver for AC SE (solver.jl:390-402)."""
    if verbose not in (2, 3):
        return
    f = _out(file)
    if iteration % 10 == 0:
        print("-" * 47, file=f)
        print("Iteration   Objective Value   Maximum Increment", file=f)
        print("-" * 47, file=f)
    print(f"{iteration:>9} {objective:>17.8e}{increment:>20.8e}", file=f)


def print_residuals_se(residual, weights, verbose: int = 0, file=None):
    """Reference printSolver end block for SE (solver.jl:404-424)."""
    if verbose not in (2, 3):
        return
    f = _out(file)
    r = np.asarray(residual)
    w = np.asarray(weights)
    idxres = int(np.argmax(np.abs(r)))
    wrss = r * r * w
    idxwrss = int(np.argmax(wrss))
    print(file=f)
    print(" " * 20 + "Measurement   Maximum Value", file=f)
    print(f"Absolute Residual:{idxres:>13}{abs(r[idxres]):>16.4e}", file=f)
    print(f"Objective Value:{idxwrss:>15}{wrss[idxwrss]:>16.4e}\n", file=f)


# ---------------------------------------------------------------------------
# verbose >= 1: exit lines (printExit)
# ---------------------------------------------------------------------------

def print_exit(method_name: str, converged: bool, max_exceeded: bool,
               iterations: int, verbose: int = 0, file=None):
    """Reference printExit (solver.jl:426-481)."""
    if verbose == 0:
        return
    f = _out(file)
    if method_name == "dc_power_flow":
        print("EXIT: The solution of the DC power flow was found.", file=f)
        return
    if method_name == "dc_state_estimation":
        print("EXIT: The solution of the DC state estimation was found.",
              file=f)
        return
    if method_name == "pmu_state_estimation":
        print("EXIT: The solution of the PMU state estimation was found.",
              file=f)
        return
    pretty = METHOD_NAMES.get(method_name,
                              method_name.replace("_", " ").title())
    if converged:
        print(f"EXIT: The solution was found using the {pretty} method in "
              f"{iterations} iterations.", file=f)
    elif max_exceeded:
        print(f"EXIT: The {pretty} method exceeded the maximum number of "
              "iterations.", file=f)
    else:
        print(f"EXIT: The {pretty} method failed to converge.", file=f)


def print_exit_opf(converged: bool, max_exceeded: bool, verbose: int = 0,
                   file=None):
    """Reference printExit for optimization analyses (solver.jl:444-463)."""
    if verbose == 0:
        return
    f = _out(file)
    if converged:
        print("EXIT: The optimal solution was found.", file=f)
    elif max_exceeded:
        print("EXIT: The maximum number of iterations exceeded.", file=f)
    else:
        print("EXIT: The optimal solution was not found.", file=f)


# --- backward-compatible thin wrappers (old driver API) --------------------

def print_title(name: str, verbose: int):
    if verbose >= 1 and verbose not in (2, 3):
        pretty = METHOD_NAMES.get(name, name.replace("_", " ").title())
        print(f"{pretty} Solver")


def print_iteration(it: int, del_p: float, del_q: float, verbose: int):
    print_solver_pf(it, del_p, del_q, verbose)
