"""Optimal power flow on the in-house interior point (``ipm``): the DC
model (``dcopf``), the AC model (``acopf``, its derivatives from K6), their
live edits (``edit``) and user extensions (``extended``)."""

from .acopf import AcOptimalPowerFlow, ac_optimal_power_flow
from .acopf import solve as _solve_ac
from .dcopf import DcOptimalPowerFlow, dc_optimal_power_flow
from .dcopf import solve as _solve_dc
from .edit import (fix, remove_constraint, set_bound, unfix, update_cost,
                   update_demand)


def solve_opf(analysis, **kwargs):
    """Reference solve!/powerFlow! for OPF analyses — dispatches on type."""
    if isinstance(analysis, AcOptimalPowerFlow):
        return _solve_ac(analysis, **kwargs)
    if isinstance(analysis, DcOptimalPowerFlow):
        return _solve_dc(analysis, **kwargs)
    raise TypeError(
        f"unsupported analysis {type(analysis).__name__}: solve_opf takes an "
        "AC or DC optimal power flow")
