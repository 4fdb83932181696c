"""Host-side power-system data model.

Structure-of-arrays equivalent of the reference types in
JuliaGrid src/definition/system.jl:51-271. These are the *mutable,
host-side* containers driven by builders and parsers; device solvers consume
frozen array snapshots compiled from them (see system/arrays.py). Internal
indices are 0-based.

Revision counters implement the staleness protocol of
``SystemRevision``/``bump!`` (definition/system.jl:223-233,
backend/utility.jl:75-148): analyses snapshot the counters they depend on and
decide at solve time whether to reuse, refactorize, or rebuild.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..utils.labels import LabelRegistry
from ..utils.vec import Vec
from ..utils.errors import DeviceStatusError, SlackBusError


@dataclass
class SystemRevision:
    topology: int = 0
    type: int = 0
    slack: int = 0
    ac_model: int = 0
    ac_pattern: int = 0
    dc_model: int = 0
    dc_pattern: int = 0
    ac_optimization: int = 0
    dc_optimization: int = 0
    #: bumped when bus injections (demand or generator supply) change
    injection: int = 0


@dataclass
class BusDemand:
    active: Vec = field(default_factory=Vec)
    reactive: Vec = field(default_factory=Vec)


@dataclass
class BusSupply:
    active: Vec = field(default_factory=Vec)
    reactive: Vec = field(default_factory=Vec)
    #: bus index -> list of in-service generator indices (insertion order)
    generator: dict = field(default_factory=dict)


@dataclass
class BusShunt:
    conductance: Vec = field(default_factory=Vec)
    susceptance: Vec = field(default_factory=Vec)


@dataclass
class BusVoltage:
    magnitude: Vec = field(default_factory=Vec)
    angle: Vec = field(default_factory=Vec)
    min_magnitude: Vec = field(default_factory=Vec)
    max_magnitude: Vec = field(default_factory=Vec)


@dataclass
class BusLayout:
    type: Vec = field(default_factory=lambda: Vec("int8"))
    area: Vec = field(default_factory=lambda: Vec("int64"))
    loss_zone: Vec = field(default_factory=lambda: Vec("int64"))
    slack: int = -1
    #: whether OPF-only fields (limits, costs) are populated
    optimal: bool = True


@dataclass
class Bus:
    label: LabelRegistry = field(default_factory=LabelRegistry)
    demand: BusDemand = field(default_factory=BusDemand)
    supply: BusSupply = field(default_factory=BusSupply)
    shunt: BusShunt = field(default_factory=BusShunt)
    voltage: BusVoltage = field(default_factory=BusVoltage)
    layout: BusLayout = field(default_factory=BusLayout)
    number: int = 0


@dataclass
class BranchParameter:
    resistance: Vec = field(default_factory=Vec)
    reactance: Vec = field(default_factory=Vec)
    conductance: Vec = field(default_factory=Vec)
    susceptance: Vec = field(default_factory=Vec)
    turns_ratio: Vec = field(default_factory=Vec)
    shift_angle: Vec = field(default_factory=Vec)


@dataclass
class BranchFlow:
    min_from_bus: Vec = field(default_factory=Vec)
    max_from_bus: Vec = field(default_factory=Vec)
    min_to_bus: Vec = field(default_factory=Vec)
    max_to_bus: Vec = field(default_factory=Vec)
    #: 1 = active power, 2/3 = apparent power (3 squared), 4/5 = current (5 squared)
    type: Vec = field(default_factory=lambda: Vec("int8"))


@dataclass
class BranchVoltage:
    min_diff_angle: Vec = field(default_factory=Vec)
    max_diff_angle: Vec = field(default_factory=Vec)


@dataclass
class BranchLayout:
    from_bus: Vec = field(default_factory=lambda: Vec("int64"))
    to_bus: Vec = field(default_factory=lambda: Vec("int64"))
    status: Vec = field(default_factory=lambda: Vec("int8"))
    inservice: int = 0


@dataclass
class Branch:
    label: LabelRegistry = field(default_factory=LabelRegistry)
    parameter: BranchParameter = field(default_factory=BranchParameter)
    flow: BranchFlow = field(default_factory=BranchFlow)
    voltage: BranchVoltage = field(default_factory=BranchVoltage)
    layout: BranchLayout = field(default_factory=BranchLayout)
    number: int = 0


@dataclass
class GeneratorOutput:
    active: Vec = field(default_factory=Vec)
    reactive: Vec = field(default_factory=Vec)


@dataclass
class GeneratorCapability:
    min_active: Vec = field(default_factory=Vec)
    max_active: Vec = field(default_factory=Vec)
    min_reactive: Vec = field(default_factory=Vec)
    max_reactive: Vec = field(default_factory=Vec)
    low_active: Vec = field(default_factory=Vec)
    min_low_reactive: Vec = field(default_factory=Vec)
    max_low_reactive: Vec = field(default_factory=Vec)
    up_active: Vec = field(default_factory=Vec)
    min_up_reactive: Vec = field(default_factory=Vec)
    max_up_reactive: Vec = field(default_factory=Vec)


@dataclass
class Cost:
    """Cost data for one power kind (active or reactive).

    ``model[i]``: 0 = none, 1 = piecewise linear, 2 = polynomial
    (matching MATPOWER / the reference Cost struct).
    """

    model: Vec = field(default_factory=lambda: Vec("int8"))
    #: generator index -> coefficient vector (highest degree first, pu)
    polynomial: dict = field(default_factory=dict)
    #: generator index -> (points, 2) matrix of (power pu, cost) breakpoints
    piecewise: dict = field(default_factory=dict)


@dataclass
class GeneratorVoltage:
    magnitude: Vec = field(default_factory=Vec)


@dataclass
class GeneratorLayout:
    bus: Vec = field(default_factory=lambda: Vec("int64"))
    status: Vec = field(default_factory=lambda: Vec("int8"))
    inservice: int = 0


@dataclass
class GeneratorCost:
    active: Cost = field(default_factory=Cost)
    reactive: Cost = field(default_factory=Cost)


@dataclass
class Generator:
    label: LabelRegistry = field(default_factory=LabelRegistry)
    output: GeneratorOutput = field(default_factory=GeneratorOutput)
    capability: GeneratorCapability = field(default_factory=GeneratorCapability)
    voltage: GeneratorVoltage = field(default_factory=GeneratorVoltage)
    layout: GeneratorLayout = field(default_factory=GeneratorLayout)
    cost: GeneratorCost = field(default_factory=GeneratorCost)
    number: int = 0


@dataclass
class BasePower:
    value: float = 1e8  # VA
    unit: str = "VA"
    prefix: float = 1.0


@dataclass
class BaseVoltage:
    value: Vec = field(default_factory=Vec)  # per bus, V
    unit: str = "V"
    prefix: float = 1.0


@dataclass
class BaseData:
    power: BasePower = field(default_factory=BasePower)
    voltage: BaseVoltage = field(default_factory=BaseVoltage)


@dataclass
class AcModel:
    """AC nodal model (reference ``AcModel``, definition/system.jl:213-221).

    ``nodal`` is the bus admittance matrix in CSR; the four per-branch
    two-port parameters and the series admittance are kept so incremental
    branch updates can add/subtract stamps without reassembly.
    """

    nodal: Optional[sp.csr_matrix] = None
    nodal_from_from: Optional[np.ndarray] = None
    nodal_from_to: Optional[np.ndarray] = None
    nodal_to_from: Optional[np.ndarray] = None
    nodal_to_to: Optional[np.ndarray] = None
    admittance: Optional[np.ndarray] = None


@dataclass
class DcModel:
    """DC nodal model (reference ``DcModel``, definition/system.jl:206-210)."""

    nodal: Optional[sp.csr_matrix] = None
    admittance: Optional[np.ndarray] = None
    shift_power: Optional[np.ndarray] = None


@dataclass
class Model:
    ac: AcModel = field(default_factory=AcModel)
    dc: DcModel = field(default_factory=DcModel)
    revision: SystemRevision = field(default_factory=SystemRevision)


@dataclass
class PowerSystem:
    bus: Bus = field(default_factory=Bus)
    branch: Branch = field(default_factory=Branch)
    generator: Generator = field(default_factory=Generator)
    base: BaseData = field(default_factory=BaseData)
    model: Model = field(default_factory=Model)

    # -- revision bumpers (reference backend/utility.jl:75-148) ------------
    def topology_changed(self):
        r = self.model.revision
        r.topology += 1
        self.ac_model_changed()
        self.dc_model_changed()
        r.ac_pattern += 1
        r.dc_pattern += 1

    def type_changed(self):
        self.model.revision.type += 1

    def slack_changed(self):
        self.model.revision.slack += 1

    def ac_model_changed(self):
        r = self.model.revision
        r.ac_model += 1
        r.ac_optimization += 1

    def dc_model_changed(self):
        r = self.model.revision
        r.dc_model += 1
        r.dc_optimization += 1

    def ac_pattern_changed(self):
        self.model.revision.ac_pattern += 1

    def dc_pattern_changed(self):
        self.model.revision.dc_pattern += 1

    def injection_changed(self):
        r = self.model.revision
        r.injection += 1
        r.ac_optimization += 1
        r.dc_optimization += 1

    def optimization_changed(self):
        r = self.model.revision
        r.ac_optimization += 1
        r.dc_optimization += 1

    # -- convenience -------------------------------------------------------
    def add_gen_in_bus(self, bus_idx: int, gen_idx: int):
        self.bus.supply.generator.setdefault(bus_idx, []).append(gen_idx)

    def check_slack(self):
        if self.bus.layout.slack < 0:
            raise SlackBusError("The slack bus is missing.")


def check_status(status) -> int:
    status = int(status)
    if status not in (0, 1):
        raise DeviceStatusError(
            f"the status {status} is not allowed; it should be "
            "in-service (1) or out-of-service (0)")
    return status
