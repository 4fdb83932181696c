"""Measurement data model (reference definition/system.jl:274-430).

Five device families over a common ``GaussMeter`` (mean, variance, status)
core: voltmeters (bus |V|), ammeters (branch |I| from/to, optionally
squared), wattmeters (P injection / Pij / Pji), varmeters (reactive
equivalents), and PMUs (paired magnitude+angle phasors at buses and branch
ends, with per-device ``polar``/``correlated``/``square`` semantics).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.labels import LabelRegistry
from ..utils.vec import Vec
from .revision import MeasurementRevision


@dataclass
class GaussMeter:
    mean: Vec = field(default_factory=Vec)
    variance: Vec = field(default_factory=Vec)
    status: Vec = field(default_factory=lambda: Vec("int8"))


@dataclass
class VoltmeterLayout:
    index: Vec = field(default_factory=lambda: Vec("int64"))  # bus index


@dataclass
class AmmeterLayout:
    index: Vec = field(default_factory=lambda: Vec("int64"))  # branch index
    from_: Vec = field(default_factory=lambda: Vec("bool"))
    to: Vec = field(default_factory=lambda: Vec("bool"))
    square: Vec = field(default_factory=lambda: Vec("bool"))


@dataclass
class PowermeterLayout:
    index: Vec = field(default_factory=lambda: Vec("int64"))  # bus or branch
    bus: Vec = field(default_factory=lambda: Vec("bool"))
    from_: Vec = field(default_factory=lambda: Vec("bool"))
    to: Vec = field(default_factory=lambda: Vec("bool"))


@dataclass
class PmuLayout:
    index: Vec = field(default_factory=lambda: Vec("int64"))  # bus or branch
    bus: Vec = field(default_factory=lambda: Vec("bool"))
    from_: Vec = field(default_factory=lambda: Vec("bool"))
    to: Vec = field(default_factory=lambda: Vec("bool"))
    correlated: Vec = field(default_factory=lambda: Vec("bool"))
    polar: Vec = field(default_factory=lambda: Vec("bool"))
    square: Vec = field(default_factory=lambda: Vec("bool"))


@dataclass
class Voltmeter:
    label: LabelRegistry = field(default_factory=LabelRegistry)
    magnitude: GaussMeter = field(default_factory=GaussMeter)
    layout: VoltmeterLayout = field(default_factory=VoltmeterLayout)
    number: int = 0


@dataclass
class Ammeter:
    label: LabelRegistry = field(default_factory=LabelRegistry)
    magnitude: GaussMeter = field(default_factory=GaussMeter)
    layout: AmmeterLayout = field(default_factory=AmmeterLayout)
    number: int = 0


@dataclass
class Wattmeter:
    label: LabelRegistry = field(default_factory=LabelRegistry)
    active: GaussMeter = field(default_factory=GaussMeter)
    layout: PowermeterLayout = field(default_factory=PowermeterLayout)
    number: int = 0


@dataclass
class Varmeter:
    label: LabelRegistry = field(default_factory=LabelRegistry)
    reactive: GaussMeter = field(default_factory=GaussMeter)
    layout: PowermeterLayout = field(default_factory=PowermeterLayout)
    number: int = 0


@dataclass
class Pmu:
    label: LabelRegistry = field(default_factory=LabelRegistry)
    magnitude: GaussMeter = field(default_factory=GaussMeter)
    angle: GaussMeter = field(default_factory=GaussMeter)
    layout: PmuLayout = field(default_factory=PmuLayout)
    number: int = 0


@dataclass
class Measurement:
    system: object = None
    voltmeter: Voltmeter = field(default_factory=Voltmeter)
    ammeter: Ammeter = field(default_factory=Ammeter)
    wattmeter: Wattmeter = field(default_factory=Wattmeter)
    varmeter: Varmeter = field(default_factory=Varmeter)
    pmu: Pmu = field(default_factory=Pmu)
    revision: MeasurementRevision = field(default_factory=MeasurementRevision)

    def changed(self):
        """Structural edit: row layout/kinds may differ. Implies values."""
        self.revision.measurement += 1
        self.revision.values += 1

    def changed_values(self):
        """Numeric-only edit (means/variances/statuses): analyses patch
        their per-row value vectors without rebuilding row snapshots."""
        self.revision.values += 1
