"""Live edits of a built AC or DC OPF model — no rebuild.

Port of ``juliagrid_tpu/opf/edit.py`` (the reference's live-model plumbing,
optimalPowerFlow/utility.jl:525-700 ``fix!``/``unfix!``/``remove!``/
``setBound!`` and the update-on-analysis overloads in
powerSystem/generator.jl:382-567): each function patches the analysis'
spec in place — list surgery, then ``_finalize``, which rebuilds the spec's
index and coefficient tensors (and, for the AC model, K6's tables) from the
lists — and re-captures the revision signature so ``_refresh_spec`` does
not clobber the patched model. A demand edit only rewrites the demand
tensors; a cost edit that changes the epigraph helpers (the state size)
rebuilds the spec. Every edit arms ``_carry_duals`` so the next ``solve``
warm-starts y/z/s from the previous optimum (the reference's
``setdual``/``transferdual!`` carry).
"""

from __future__ import annotations

import numpy as np
import torch

from ..system.builders import cost as _cost_builder
from ..system.builders import update_bus, update_generator
from .acopf import AcOptimalPowerFlow
from .dcopf import DcOptimalPowerFlow

_VARS = ("magnitude", "active", "reactive")


def _live_spec(analysis):
    if not isinstance(analysis, (AcOptimalPowerFlow, DcOptimalPowerFlow)):
        raise ValueError(
            "live OPF edits require an AC or DC optimal power flow analysis")
    analysis._refresh_spec()
    return analysis._spec


def _is_dc(analysis):
    return isinstance(analysis, DcOptimalPowerFlow)


def _recapture(analysis):
    """Mark the patched spec current for the system's revision counters and
    arm the dual carry for the next solve."""
    rev = analysis.system.model.revision
    if _is_dc(analysis):
        key = (rev.dc_model, rev.dc_pattern, rev.dc_optimization,
               rev.injection, rev.slack)
    else:
        key = (rev.ac_model, rev.ac_pattern, rev.ac_optimization,
               rev.injection, rev.slack, rev.type)
    analysis.signature = {"key": key}
    analysis._carry_duals = True
    if analysis._x0 is not None:
        x0 = np.asarray(analysis._x0, dtype=np.float64).copy()
        analysis._spec.push_inside(x0)
        analysis._x0 = x0


def _rebuild(analysis):
    """The signature-gated full rebuild (a changed state size), with the
    dual carry armed for the layout check to accept or refuse."""
    analysis.signature = None
    analysis._refresh_spec()
    analysis._carry_duals = True
    return analysis


def _replace_or_append(lst, i, val):
    """Update the pair list preserving row order (and hence dual alignment)
    when the entry already exists."""
    for k, (j, _) in enumerate(lst):
        if j == i:
            lst[k] = (i, float(val))
            return
    lst.append((i, float(val)))


def _drop(lst, i):
    lst[:] = [t for t in lst if t[0] != i]


def _rebuild_membership(i, lo, hi, lo_lst, hi_lst, fix_lst):
    """Re-derive one variable's box/fixed membership from its (lo, hi) —
    the same rules as the spec build."""
    if np.isfinite(lo) and lo == hi:
        _drop(lo_lst, i)
        _drop(hi_lst, i)
        _replace_or_append(fix_lst, i, lo)
        return
    _drop(fix_lst, i)
    if np.isfinite(lo):
        _replace_or_append(lo_lst, i, lo)
    else:
        _drop(lo_lst, i)
    if np.isfinite(hi):
        _replace_or_append(hi_lst, i, hi)
    else:
        _drop(hi_lst, i)


def _check_dc_variable(variable):
    if variable != "active":
        raise ValueError(
            "the DC optimal power flow model carries only the active "
            f"generator output variable, got {variable!r}")


def _bounds_of(analysis, variable, label):
    """(index, current lo, current hi, lo list, hi list, fixed list) of a
    variable of the spec."""
    spec, system = analysis._spec, analysis.system
    if _is_dc(analysis):
        _check_dc_variable(variable)
        i = system.generator.label.index(label)
        cap = system.generator.capability
        return (i, float(cap.min_active[i]), float(cap.max_active[i]),
                spec.cap_lo, spec.cap_hi, spec.fix_p)
    if variable == "magnitude":
        i = system.bus.label.index(label)
        lo = float(system.bus.voltage.min_magnitude[i])
        hi = float(system.bus.voltage.max_magnitude[i])
        return i, lo, hi, spec.v_lo, spec.v_hi, spec.fix_v
    cap = system.generator.capability
    if variable == "active":
        i = system.generator.label.index(label)
        return (i, float(cap.min_active[i]), float(cap.max_active[i]),
                spec.p_lo, spec.p_hi, spec.fix_p)
    if variable == "reactive":
        i = system.generator.label.index(label)
        return (i, float(cap.min_reactive[i]), float(cap.max_reactive[i]),
                spec.q_lo, spec.q_hi, spec.fix_q)
    raise ValueError(f"variable must be one of {_VARS}, got {variable!r}")


def set_bound(analysis, *, variable: str, label, min=None, max=None):
    """Reference setBound! / JuMP set_lower_bound/set_upper_bound on the
    live model (optimalPowerFlow/utility.jl:634-647). ``variable`` is
    ``magnitude`` (bus), ``active`` or ``reactive`` (generator); the DC
    model carries only ``active``."""
    spec = _live_spec(analysis)
    system = analysis.system
    if _is_dc(analysis):
        _check_dc_variable(variable)
    if variable == "magnitude":
        update_bus(system, label, min_magnitude=min, max_magnitude=max)
    elif variable == "active":
        update_generator(system, label, min_active=min, max_active=max)
    elif variable == "reactive":
        update_generator(system, label, min_reactive=min, max_reactive=max)
    else:
        raise ValueError(f"variable must be one of {_VARS}, got {variable!r}")
    i, lo, hi, lo_lst, hi_lst, fix_lst = _bounds_of(analysis, variable,
                                                    label)
    if variable in ("active", "reactive") and not spec.gen_on[i]:
        raise ValueError(
            "The variable belongs to an out-of-service generator; its "
            "output is fixed at zero and has no bounds to set.")
    _rebuild_membership(i, lo, hi, lo_lst, hi_lst, fix_lst)
    spec._finalize()
    _recapture(analysis)
    return analysis


def fix(analysis, *, variable: str, label, value=None):
    """Reference fix! (optimalPowerFlow/utility.jl:525-536): pin a variable
    at ``value`` (default: its current solution / start value). The
    original bounds are remembered for ``unfix``."""
    spec = _live_spec(analysis)
    i, lo, hi, *_ = _bounds_of(analysis, variable, label)
    if value is None:
        n = spec.n
        if _is_dc(analysis):
            pos = n + i
        else:
            pos = {"magnitude": n, "active": 2 * n,
                   "reactive": 2 * n + spec.g}[variable] + i
        value = float(np.asarray(analysis._x0)[pos])
    # the pre-fix bounds live on the analysis (not the spec), so they
    # survive a rebuild of the spec
    if not hasattr(analysis, "_prefix_bounds"):
        analysis._prefix_bounds = {}
    analysis._prefix_bounds.setdefault((variable, i), (lo, hi))
    return set_bound(analysis, variable=variable, label=label,
                     min=value, max=value)


def unfix(analysis, *, variable: str, label):
    """Reference unfix! (optimalPowerFlow/utility.jl:538-544): release a
    fixed variable back to the bounds it had before ``fix``."""
    _live_spec(analysis)
    i, *_ = _bounds_of(analysis, variable, label)
    try:
        lo, hi = getattr(analysis, "_prefix_bounds", {}).pop((variable, i))
    except KeyError:
        raise ValueError(
            f"the {variable} variable of {label!r} has no recorded fix to "
            "release; call fix() before unfix()") from None
    return set_bound(analysis, variable=variable, label=label,
                     min=lo, max=hi)


def remove_constraint(analysis, *, constraint: str, label):
    """Reference remove! on a live analysis (optimalPowerFlow/
    utility.jl:546-632): drop a constraint group member from the model
    without touching the system data — rebuilding the analysis restores
    it."""
    spec = _live_spec(analysis)
    system = analysis.system
    dc = _is_dc(analysis)
    if constraint == "flow":
        i = system.branch.label.index(label)
        at = 6 if dc else 0   # where each spec's flow tuple keeps the branch
        spec.flows = [f for f in spec.flows if f[at] != i]
    elif constraint == "angle":
        i = system.branch.label.index(label)
        spec.angles = [a for a in spec.angles if a[4] != i]
    elif constraint == "capability" and dc:
        i = system.generator.label.index(label)
        _drop(spec.cap_lo, i)
        _drop(spec.cap_hi, i)
    elif constraint == "capability":
        i = system.generator.label.index(label)
        spec.curve_cuts = [c for c in spec.curve_cuts if c[0] != i]
        spec.curve_tags = [t for t in spec.curve_tags if t[0] != i]
    elif constraint == "voltage" and not dc:
        i = system.bus.label.index(label)
        _drop(spec.v_lo, i)
        _drop(spec.v_hi, i)
    elif constraint == "balance":
        raise ValueError(
            "The power balance constraints cannot be removed from the "
            f"{'DC' if dc else 'AC'} optimal power flow model; deactivate "
            "the bus instead.")
    else:
        names = ("flow", "angle", "capability") if dc else (
            "flow", "angle", "capability", "voltage")
        raise ValueError(
            f"constraint must be one of {names}, got {constraint!r}")
    spec._finalize()
    _recapture(analysis)
    return analysis


def update_demand(analysis, label, *, active=None, reactive=None):
    """Reference updateBus!(system, analysis; ...) on demand: a value-only
    edit of the balance right-hand side (bus.jl:260-308 overload)."""
    spec = _live_spec(analysis)
    system = analysis.system
    update_bus(system, label, active=active, reactive=reactive)
    n = system.bus.number

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=spec.device)

    if _is_dc(analysis):
        spec.rhs = (system.bus.demand.active.array[:n]
                    + system.bus.shunt.conductance.array[:n]
                    + system.model.dc.shift_power)
        spec.arrays = spec.arrays._replace(rhs=f64(spec.rhs))
    else:
        spec.pd = np.asarray(system.bus.demand.active.array[:n]).copy()
        spec.qd = np.asarray(system.bus.demand.reactive.array[:n]).copy()
        spec.arrays = spec.arrays._replace(pd=f64(spec.pd), qd=f64(spec.qd))
    _recapture(analysis)
    return analysis


def _splice_ac_cost(spec, system, i, kind):
    """Splice generator ``i``'s polynomial or two-point piecewise cost of
    ``kind`` ('p' or 'q') into ``spec.poly_terms`` in place. False when
    the epigraph helpers are involved (the caller rebuilds)."""
    cost_store = system.generator.cost.reactive if kind == "q" \
        else system.generator.cost.active
    pw_gens = spec.pw_gens_q if kind == "q" else spec.pw_gens_p
    cmodel = int(cost_store.model[i])
    if cmodel == 1 and i in cost_store.piecewise \
            and len(np.asarray(cost_store.piecewise[i])) > 2 \
            or i in pw_gens:
        return False
    if cmodel == 2 and i in cost_store.polynomial:
        coeffs = np.asarray(cost_store.polynomial[i], dtype=float)
    elif cmodel == 1 and i in cost_store.piecewise:
        pts = np.asarray(cost_store.piecewise[i])
        if len(pts) != 2:
            raise ValueError("piecewise cost requires at least two points")
        slope = (pts[1, 1] - pts[0, 1]) / (pts[1, 0] - pts[0, 0])
        coeffs = np.asarray([slope, pts[0, 1] - pts[0, 0] * slope])
    else:
        coeffs = None
    for k, (kd, gi, _co) in enumerate(spec.poly_terms):
        if kd == kind and gi == i:
            if coeffs is None:
                del spec.poly_terms[k]
            else:
                spec.poly_terms[k] = (kind, i, coeffs)
            break
    else:
        if coeffs is not None:
            spec.poly_terms.append((kind, i, coeffs))
    return True


def update_cost(analysis, label, *, active=None, reactive=None,
                polynomial=None, piecewise=None):
    """Reference cost!(system, analysis; ...) (generator.jl:382-567): patch
    a generator's objective on the live model. Polynomial and two-point
    piecewise edits splice the cost term in place; edits that change the
    epigraph helpers (the state size) take the signature-gated full
    rebuild, like the reference rebuilding its JuMP objective."""
    spec = _live_spec(analysis)
    system = analysis.system
    _cost_builder(system, label, active=active, reactive=reactive,
                  polynomial=polynomial, piecewise=piecewise)
    i = system.generator.label.index(label)
    if not spec.gen_on[i]:
        return analysis  # off generators carry no objective term
    if _is_dc(analysis):
        old_pw = list(spec.pw_gens)
        spec._build_objective(system)
        if spec.pw_gens != old_pw:
            return _rebuild(analysis)
    else:
        # active= and reactive= can come together: splice both sides
        for kind in [k for k, flag in (("p", active), ("q", reactive))
                     if flag is not None]:
            if not _splice_ac_cost(spec, system, i, kind):
                return _rebuild(analysis)
    spec._finalize()
    _recapture(analysis)
    return analysis
