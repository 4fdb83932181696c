"""Live edits of a built DC OPF model — no rebuild.

Port of the DC half of ``juliagrid_tpu/opf/edit.py`` (the reference's
live-model plumbing, optimalPowerFlow/utility.jl:525-700 ``fix!``/
``unfix!``/``remove!``/``setBound!`` and the update-on-analysis overloads
in powerSystem/generator.jl:382-567): each function patches the analysis'
``_DcSpec`` in place — list surgery, then ``_finalize``, which rebuilds the
spec's index and coefficient tensors from the lists (B stays) — and
re-captures the revision signature so ``_refresh_spec`` does not clobber
the patched model. Every edit arms ``_carry_duals`` so the next ``solve``
warm-starts y/z/s from the previous optimum (the reference's
``setdual``/``transferdual!`` carry).

The AC OPF model is not ported yet: the AC branches raise, naming ROADMAP
item 12c.
"""

from __future__ import annotations

import numpy as np
import torch

from ..system.builders import cost as _cost_builder
from ..system.builders import update_bus, update_generator
from .dcopf import DcOptimalPowerFlow


def _live_spec(analysis):
    if not isinstance(analysis, DcOptimalPowerFlow):
        raise NotImplementedError(
            "live OPF edits run on a DC optimal power flow analysis; the AC "
            "optimal power flow is not ported yet (ROADMAP item 12c)")
    analysis._refresh_spec()
    return analysis._spec


def _recapture(analysis):
    """Mark the patched spec current for the system's revision counters and
    arm the dual carry for the next solve."""
    rev = analysis.system.model.revision
    analysis.signature = {"key": (rev.dc_model, rev.dc_pattern,
                                  rev.dc_optimization, rev.injection,
                                  rev.slack)}
    analysis._carry_duals = True
    if analysis._x0 is not None:
        x0 = np.asarray(analysis._x0, dtype=np.float64).copy()
        analysis._spec.push_inside(x0)
        analysis._x0 = x0


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


def _check_active(variable):
    if variable != "active":
        raise ValueError(
            "the DC optimal power flow model carries only the active "
            f"generator output variable, got {variable!r}")


def set_bound(analysis, *, variable: str, label, min=None, max=None):
    """Reference setBound! / JuMP set_lower_bound/set_upper_bound on the
    live model (optimalPowerFlow/utility.jl:634-647); the DC model carries
    only ``active``."""
    spec = _live_spec(analysis)
    system = analysis.system
    _check_active(variable)
    update_generator(system, label, min_active=min, max_active=max)
    i = system.generator.label.index(label)
    if not spec.gen_on[i]:
        raise ValueError(
            "The variable belongs to an out-of-service generator; its "
            "output is fixed at zero and has no bounds to set.")
    cap = system.generator.capability
    _rebuild_membership(i, float(cap.min_active[i]), float(cap.max_active[i]),
                        spec.cap_lo, spec.cap_hi, spec.fix_p)
    spec._finalize()
    _recapture(analysis)
    return analysis


def fix(analysis, *, variable: str, label, value=None):
    """Reference fix! (optimalPowerFlow/utility.jl:525-536): pin a variable
    at ``value`` (default: its current solution / start value). The
    original bounds are remembered for ``unfix``."""
    spec = _live_spec(analysis)
    system = analysis.system
    _check_active(variable)
    i = system.generator.label.index(label)
    cap = system.generator.capability
    lo, hi = float(cap.min_active[i]), float(cap.max_active[i])
    if value is None:
        value = float(np.asarray(analysis._x0)[spec.n + i])
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
    i = analysis.system.generator.label.index(label)
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
    if constraint == "flow":
        i = system.branch.label.index(label)
        spec.flows = [f for f in spec.flows if f[6] != i]
    elif constraint == "angle":
        i = system.branch.label.index(label)
        spec.angles = [a for a in spec.angles if a[4] != i]
    elif constraint == "capability":
        i = system.generator.label.index(label)
        _drop(spec.cap_lo, i)
        _drop(spec.cap_hi, i)
    elif constraint == "balance":
        raise ValueError(
            "The power balance constraints cannot be removed from the "
            "DC optimal power flow model; deactivate the bus instead.")
    else:
        raise ValueError(
            "constraint must be one of ('flow', 'angle', "
            f"'capability'), got {constraint!r}")
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
    spec.rhs = (system.bus.demand.active.array[:n]
                + system.bus.shunt.conductance.array[:n]
                + system.model.dc.shift_power)
    spec.arrays = spec.arrays._replace(rhs=torch.as_tensor(
        spec.rhs, dtype=torch.float64, device=spec.device))
    _recapture(analysis)
    return analysis


def update_cost(analysis, label, *, active=None, reactive=None,
                polynomial=None, piecewise=None):
    """Reference cost!(system, analysis; ...) (generator.jl:382-567): patch
    a generator's objective on the live model. Edits that change the
    epigraph helper count (the state size) take the signature-gated full
    rebuild, like the reference rebuilding its JuMP objective."""
    spec = _live_spec(analysis)
    system = analysis.system
    _cost_builder(system, label, active=active, reactive=reactive,
                  polynomial=polynomial, piecewise=piecewise)
    i = system.generator.label.index(label)
    if not spec.gen_on[i]:
        return analysis  # off generators carry no objective term
    old_pw = list(spec.pw_gens)
    spec._build_objective(system)
    if spec.pw_gens != old_pw:
        # epigraph helper layout changed: state size/slot mapping moved,
        # take the signature-gated full rebuild
        analysis.signature = None
        analysis._refresh_spec()
        analysis._carry_duals = True
        return analysis
    spec._finalize()
    _recapture(analysis)
    return analysis
