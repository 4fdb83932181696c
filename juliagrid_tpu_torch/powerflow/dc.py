"""DC power flow on PyTorch tensors.

Port of ``juliagrid_tpu/powerflow/dc.py`` (itself after JuliaGrid
src/powerFlow/dcPowerFlow.jl). One masked linear solve: B θ = P_injected -
P_shift - G_shunt with the slack row/column masked to identity
(dcPowerFlow.jl:89-134), then the slack angle added back, as one dense f64
``torch.linalg`` factorization (``ops/linalg.py``). The dense B is assembled
on the analysis device from the nodal matrix's COO entries, so no dense
n x n copy is made on the host. ``parallel.batched_dc_solve`` solves a fleet
of injection vectors against one factorization.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..ops import linalg
from ..system.model import model
from ..system.types import PowerSystem
from .ac import MethodState, change_slack_bus


class DcArrays(NamedTuple):
    """Device snapshot of the DC model."""

    b_dense: torch.Tensor  # f64[n, n] nodal matrix B (unmasked)
    slack: int             # slack bus index
    p_sched: torch.Tensor  # f64[n] supply - demand
    shift: torch.Tensor    # f64[n] shift-angle power
    gshunt: torch.Tensor   # f64[n] shunt conductance
    slack_angle: float     # stored angle of the slack bus


@dataclass
class Angle:
    angle: np.ndarray


@dataclass
class DcPowerFlow:
    system: PowerSystem
    voltage: Angle
    method: MethodState
    arrays: DcArrays
    device: torch.device
    power: Optional[object] = None
    signature: dict = field(default_factory=dict)

    def _refresh_arrays(self):
        """Rebuild the device snapshot when the DC model, the injections or
        the slack moved past the captured revision."""
        rev = self.system.model.revision
        sig = self.signature
        if (sig.get("dc_model") != rev.dc_model
                or sig.get("dc_pattern") != rev.dc_pattern
                or sig.get("injection") != rev.injection
                or sig.get("slack") != rev.slack):
            self.arrays = compile_dc_arrays(self.system, self.device)
            sig.update(dc_model=rev.dc_model, dc_pattern=rev.dc_pattern,
                       injection=rev.injection, slack=rev.slack)


def compile_dc_arrays(system: PowerSystem, device=None) -> DcArrays:
    # convert.py builds DcArrays from numpy and imports this module
    from ..convert import dc_arrays_from_numpy

    model(system, "dc")
    n = system.bus.number
    bus = system.bus
    coo = system.model.dc.nodal.tocoo()
    dev = resolve_device(device)
    return dc_arrays_from_numpy(
        b_dense=linalg.dense_from_coo(coo.row, coo.col, coo.data, n, dev),
        slack=bus.layout.slack,
        p_sched=bus.supply.active.array[:n] - bus.demand.active.array[:n],
        shift=system.model.dc.shift_power,
        gshunt=bus.shunt.conductance.array[:n],
        slack_angle=bus.voltage.angle[int(bus.layout.slack)],
        device=dev)


def _masked_b(arr: DcArrays) -> tuple[torch.Tensor, torch.Tensor]:
    """The slack-masked B (a new tensor) and the 0/1 mask."""
    n = arr.b_dense.shape[0]
    active = torch.arange(n, device=arr.b_dense.device) != arr.slack
    b = linalg.mask_identity(arr.b_dense.clone(), active)
    return b, active.to(b.dtype)


def _dc_solve(arr: DcArrays, kind: str) -> torch.Tensor:
    """Bus angles of one DC power flow: masked B, factorization ``kind``
    (``ops/linalg.py``), solve, slack angle added."""
    b, m = _masked_b(arr)
    rhs = arr.p_sched - arr.shift - arr.gshunt
    theta = linalg.solve(linalg.factorize(b, kind), rhs * m)
    return theta + arr.slack_angle


def dc_power_flow(system: PowerSystem, factorization: str = linalg.LU,
                  device=None) -> DcPowerFlow:
    """Reference dcPowerFlow (dcPowerFlow.jl:42-70) on ``device`` (default
    ``config.device``)."""
    device = resolve_device(device)
    system.check_slack()
    change_slack_bus(system)
    model(system, "dc")
    arrays = compile_dc_arrays(system, device)
    rev = system.model.revision
    return DcPowerFlow(
        system=system,
        voltage=Angle(np.zeros(system.bus.number)),
        method=MethodState("dc_power_flow", factorization),
        arrays=arrays,
        device=device,
        signature={"dc_model": rev.dc_model, "dc_pattern": rev.dc_pattern,
                   "injection": rev.injection, "slack": rev.slack},
    )


def dc_solve(analysis: DcPowerFlow, verbose: int | None = None):
    """Reference solve! for DC power flow."""
    verbose = 0 if verbose is None else verbose
    if verbose:
        from ..report.solver import print_exit, print_middle_pf, print_top
        print_top(analysis.system, analysis, verbose)
        print_middle_pf(analysis.system, analysis, verbose)
    analysis._refresh_arrays()
    theta = _dc_solve(analysis.arrays, analysis.method.factorization)
    analysis.voltage.angle = theta.cpu().numpy()
    analysis.method.converged = True
    if verbose:
        print_exit("dc_power_flow", True, False, 0, verbose)
    return analysis
