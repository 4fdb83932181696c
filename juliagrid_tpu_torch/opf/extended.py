"""User extensions of the OPF models: extra variables, constraints and
objective terms.

Port of ``juliagrid_tpu/opf/extended.py``, the counterpart of the
reference's ``@addVariable``/``@addConstraint`` macros and its ``Extended``
registry (JuliaGrid src/optimalPowerFlow/extended.jl:27-265). Extensions
are torch callables over a named view of one state point, composed into the
``NlpProblem`` at solve time; no analytic derivatives are passed, so the
interior point differentiates the whole problem with ``torch.func``, as the
JAX package does with its autodiff.

Usage::

    opf = ac_optimal_power_flow(system, device="cpu")
    add_variable(opf, "reserve", dim=3, lower=0.0, start=0.1)
    add_constraint(opf, lambda s: s["reserve"].sum() - 0.5, kind="eq")
    add_objective_term(opf, lambda s: 10.0 * (s["reserve"] ** 2).sum())
    solve_extended(opf)

The view ``s`` maps names to 1-D tensors of one point: for the AC model
``angle``, ``magnitude``, ``active`` (Pg) and ``reactive`` (Qg), for the DC
model ``angle`` and ``active``, plus the user variables. A batch of points
(the line search's) goes through the callables one point at a time, under
``torch.func.vmap``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.func import vmap

from ..postprocessing.results import Cartesian
from .acopf import AcOptimalPowerFlow
from .ipm import NlpProblem, solve_nlp


@dataclass
class Extension:
    variables: list = field(default_factory=list)  # (name, dim, lo, hi, x0)
    constraints: list = field(default_factory=list)  # (fn, kind)
    objectives: list = field(default_factory=list)


def _ext(analysis) -> Extension:
    if not hasattr(analysis, "_extension"):
        analysis._extension = Extension()
    return analysis._extension


def add_variable(analysis, name: str, dim: int = 1, lower=None, upper=None,
                 start: float = 0.0):
    """Reference @addVariable: register a user variable (vector)."""
    _ext(analysis).variables.append((name, dim, lower, upper, start))


def add_constraint(analysis, fn, kind: str = "ineq"):
    """Reference @addConstraint. ``fn(state_view) -> residuals``;
    kind 'eq' targets 0, 'ineq' requires >= 0."""
    if kind not in ("eq", "ineq"):
        raise ValueError("kind must be 'eq' or 'ineq'")
    _ext(analysis).constraints.append((fn, kind))


def add_objective_term(analysis, fn):
    """Add ``fn(state_view)`` to the objective."""
    _ext(analysis).objectives.append(fn)


def remove(analysis, kind: str, index: int):
    """Reference remove!: drop a user variable/constraint/objective by
    registration index."""
    ext = _ext(analysis)
    store = {"variable": ext.variables, "constraint": ext.constraints,
             "objective": ext.objectives}[kind]
    del store[index]


def _pointwise(fn):
    """``fn`` of one point, taking ``[..., n]``: a batch goes through
    ``vmap``."""
    def batched(x):
        if x.dim() == 1:
            return fn(x)
        out = vmap(fn)(x.reshape(-1, x.shape[-1]))
        return out.reshape(x.shape[:-1] + out.shape[1:])
    return batched


def solve_extended(analysis, max_iter: int = 300, tolerance: float = 1e-8,
                   verbose: int = 0):
    """Solve the OPF with the registered extensions composed in."""
    analysis._refresh_spec()
    spec = analysis._spec
    ext = _ext(analysis)
    ac = isinstance(analysis, AcOptimalPowerFlow)
    n, g, base_n = spec.n, spec.g, spec.n_x

    offsets = {}
    pos = base_n
    for (name, dim, _lo, _hi, _start) in ext.variables:
        offsets[name] = (pos, dim)
        pos += dim
    total_n = pos

    def view_of(x):
        xb = x[:base_n]
        if ac:
            view = {"angle": xb[:n], "magnitude": xb[n:2 * n],
                    "active": xb[2 * n:2 * n + g],
                    "reactive": xb[2 * n + g:2 * n + 2 * g]}
        else:
            view = {"angle": xb[:n], "active": xb[n:n + g]}
        for name, (o, d) in offsets.items():
            view[name] = x[o:o + d]
        return xb, view

    def objective(x):
        xb, view = view_of(x)
        val = spec.objective(xb)
        for fn in ext.objectives:
            val = val + fn(view)
        return val

    def eq(x):
        xb, view = view_of(x)
        out = [spec.eq(xb)]
        out += [torch.atleast_1d(fn(view)) for fn, kind in ext.constraints
                if kind == "eq"]
        return torch.cat(out)

    def ineq(x):
        xb, view = view_of(x)
        out = [spec.ineq(xb)]
        out += [torch.atleast_1d(fn(view)) for fn, kind in ext.constraints
                if kind == "ineq"]
        for (name, _dim, lo, hi, _start) in ext.variables:
            if lo is not None:
                out.append(view[name] - lo)
            if hi is not None:
                out.append(hi - view[name])
        return torch.cat(out)

    x0 = np.zeros(total_n)
    x0[:base_n] = analysis._x0
    for (name, _dim, _lo, _hi, start) in ext.variables:
        o, d = offsets[name]
        x0[o:o + d] = start

    has_ineq = ineq(torch.as_tensor(x0, device=spec.device)).numel() > 0
    res = solve_nlp(NlpProblem(_pointwise(objective), _pointwise(eq),
                               _pointwise(ineq) if has_ineq else None),
                    x0, max_iter=max_iter, tol=tolerance, verbose=verbose,
                    device=analysis.device)

    analysis.method.result = res
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    analysis.method.objective = res.objective
    analysis.method.dual = {"extended": True}
    analysis.method.user_values = {
        name: res.x[o:o + d].copy() for name, (o, d) in offsets.items()}

    analysis.voltage.angle = res.x[:n]
    if ac:
        analysis.voltage.magnitude = res.x[n:2 * n]
        pg = res.x[2 * n:2 * n + g].copy()
        qg = res.x[2 * n + g:2 * n + 2 * g].copy()
        pg[~spec.gen_on] = 0.0
        qg[~spec.gen_on] = 0.0
        analysis.power.generator = Cartesian(active=pg, reactive=qg)
    else:
        pg = res.x[n:n + g].copy()
        pg[~spec.gen_on] = 0.0
        analysis.power.generator = Cartesian(active=pg)
    analysis._x0 = res.x[:base_n]
    return analysis
