"""Optimal power flow on the in-house interior point (``ipm``): the DC
model (``dcopf``) and its live edits (``edit``). The AC model is not
ported yet (ROADMAP item 12c)."""

from .dcopf import DcOptimalPowerFlow, dc_optimal_power_flow
from .dcopf import solve as _solve_dc
from .edit import (fix, remove_constraint, set_bound, unfix, update_cost,
                   update_demand)


def solve_opf(analysis, **kwargs):
    """Reference solve!/powerFlow! for OPF analyses — dispatches on type."""
    if isinstance(analysis, DcOptimalPowerFlow):
        return _solve_dc(analysis, **kwargs)
    raise TypeError(
        f"unsupported analysis {type(analysis).__name__}: the port solves DC "
        "optimal power flow (the AC model is ROADMAP item 12c)")
