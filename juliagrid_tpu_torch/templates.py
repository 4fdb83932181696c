"""Per-element default templates (the reference's ``@bus``/``@branch``/... macros).

Field defaults mirror JuliaGrid src/definition/internal.jl:113-260.
Each templated value is stored as ``(value, is_pu)``; ``is_pu`` records
whether the stored default is already per-unit (so later unit changes do not
reinterpret it), matching the reference's ``ContainerTemplate``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

from .units import UnitSystem, parse_unit, units

Tpl = tuple[float, bool]  # (value, is_pu)


def _t(value: float = 0.0, pu: bool = True) -> Tpl:
    return (value, pu)


@dataclass
class BusTemplate:
    active: Tpl = _t()
    reactive: Tpl = _t()
    conductance: Tpl = _t()
    susceptance: Tpl = _t()
    magnitude: Tpl = _t(1.0)
    angle: Tpl = _t()
    min_magnitude: Tpl = _t(0.9)
    max_magnitude: Tpl = _t(1.1)
    base: float = 138e3
    type: int = 1
    area: int = 0
    loss_zone: int = 0
    label: str = "?"


@dataclass
class BranchTemplate:
    resistance: Tpl = _t()
    reactance: Tpl = _t()
    conductance: Tpl = _t()
    susceptance: Tpl = _t()
    shift_angle: Tpl = _t()
    min_diff_angle: Tpl = _t(-2 * math.pi)
    max_diff_angle: Tpl = _t(2 * math.pi)
    min_from_bus: Tpl = _t()
    max_from_bus: Tpl = _t()
    min_to_bus: Tpl = _t()
    max_to_bus: Tpl = _t()
    turns_ratio: float = 1.0
    status: int = 1
    type: int = 3
    label: str = "?"


@dataclass
class GeneratorTemplate:
    active: Tpl = _t()
    reactive: Tpl = _t()
    magnitude: Tpl = _t(1.0)
    min_active: Tpl = _t()
    max_active: Tpl = _t(math.nan)
    min_reactive: Tpl = _t(math.nan)
    max_reactive: Tpl = _t(math.nan)
    low_active: Tpl = _t()
    min_low_reactive: Tpl = _t()
    max_low_reactive: Tpl = _t()
    up_active: Tpl = _t()
    min_up_reactive: Tpl = _t()
    max_up_reactive: Tpl = _t()
    status: int = 1
    label: str = "?"


@dataclass
class VoltmeterTemplate:
    variance: Tpl = _t(1e-4)
    status: int = 1
    noise: bool = False
    label: str = "?"


@dataclass
class AmmeterTemplate:
    variance_from: Tpl = _t(1e-4)
    variance_to: Tpl = _t(1e-4)
    status_from: int = 1
    status_to: int = 1
    square: bool = False
    noise: bool = False
    label: str = "?"


@dataclass
class WattmeterTemplate:
    variance_bus: Tpl = _t(1e-4)
    variance_from: Tpl = _t(1e-4)
    variance_to: Tpl = _t(1e-4)
    status_bus: int = 1
    status_from: int = 1
    status_to: int = 1
    noise: bool = False
    label: str = "?"


@dataclass
class VarmeterTemplate:
    variance_bus: Tpl = _t(1e-4)
    variance_from: Tpl = _t(1e-4)
    variance_to: Tpl = _t(1e-4)
    status_bus: int = 1
    status_from: int = 1
    status_to: int = 1
    noise: bool = False
    label: str = "?"


@dataclass
class PmuTemplate:
    variance_magnitude_bus: Tpl = _t(1e-8)
    variance_angle_bus: Tpl = _t(1e-8)
    variance_magnitude_from: Tpl = _t(1e-8)
    variance_angle_from: Tpl = _t(1e-8)
    variance_magnitude_to: Tpl = _t(1e-8)
    variance_angle_to: Tpl = _t(1e-8)
    status_bus: int = 1
    status_from: int = 1
    status_to: int = 1
    correlated: bool = False
    polar: bool = False
    square: bool = False
    noise: bool = False
    label: str = "?"


@dataclass
class Template:
    bus: BusTemplate = field(default_factory=BusTemplate)
    branch: BranchTemplate = field(default_factory=BranchTemplate)
    generator: GeneratorTemplate = field(default_factory=GeneratorTemplate)
    voltmeter: VoltmeterTemplate = field(default_factory=VoltmeterTemplate)
    ammeter: AmmeterTemplate = field(default_factory=AmmeterTemplate)
    wattmeter: WattmeterTemplate = field(default_factory=WattmeterTemplate)
    varmeter: VarmeterTemplate = field(default_factory=VarmeterTemplate)
    pmu: PmuTemplate = field(default_factory=PmuTemplate)


template = Template()

# Which unit group converts each templated field per element kind; used by
# set_template to record (value_in_pu_or_raw, is_pu) like the reference macros.
_UNIT_GROUP = {
    "active": "pfx_active", "conductance": "pfx_active",
    "reactive": "pfx_reactive", "susceptance": "pfx_reactive",
    "magnitude": "pfx_voltage", "min_magnitude": "pfx_voltage",
    "max_magnitude": "pfx_voltage",
    "angle": "pfx_angle", "shift_angle": "pfx_angle",
    "min_diff_angle": "pfx_angle", "max_diff_angle": "pfx_angle",
    "resistance": "pfx_impedance", "reactance": "pfx_impedance",
    "min_active": "pfx_active", "max_active": "pfx_active",
    "low_active": "pfx_active", "up_active": "pfx_active",
    "min_reactive": "pfx_reactive", "max_reactive": "pfx_reactive",
    "min_low_reactive": "pfx_reactive", "max_low_reactive": "pfx_reactive",
    "min_up_reactive": "pfx_reactive", "max_up_reactive": "pfx_reactive",
    "variance": "pfx_voltage",
    "variance_bus": "pfx_voltage", "variance_from": "pfx_voltage",
    "variance_to": "pfx_voltage",
}


def set_template(kind: str, **kwargs) -> None:
    """Equivalent of ``@bus(...)``, ``@branch(...)`` etc.

    Numeric templated values are stored with a flag saying whether the value
    was given per-unit (live prefix 0.0) or in SI units (stored raw with
    ``is_pu=False``; converted at add-time against the element's base).
    """
    tpl = getattr(template, kind)
    valid = {f.name for f in fields(tpl)}
    for key, value in kwargs.items():
        if key not in valid:
            raise KeyError(f"unknown {kind} template key: {key}")
        current = getattr(tpl, key)
        if isinstance(current, tuple):
            pfx_name = _UNIT_GROUP.get(key)
            pfx = getattr(units, pfx_name, 0.0) if pfx_name else 0.0
            if pfx == 0.0:
                setattr(tpl, key, (float(value), True))
            else:
                setattr(tpl, key, (float(value) * pfx, False))
        else:
            setattr(tpl, key, value)


def default_template(kind: str | None = None) -> None:
    """Equivalent of ``@default(bus)`` / ``@default(template)``."""
    if kind is None or kind == "template":
        template.__init__()
    else:
        setattr(template, kind, type(getattr(template, kind))())


def default(what: str = "all") -> None:
    """Reference ``@default(unit|template|bus|...|all)`` macro."""
    if what in ("unit", "all"):
        units.reset()
    if what in ("template", "all"):
        default_template()
    if what not in ("unit", "template", "all"):
        default_template(what)
