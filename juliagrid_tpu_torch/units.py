"""Unit system: SI prefixes, live input units, and per-unit conversion.

Functional equivalent of the reference's unit macros and conversion core:
``@base/@power/@voltage/@current/@parameter`` and ``topu``/``baseImpedance``/
``baseCurrentInv`` (JuliaGrid src/backend/internal.jl:19-236,
backend/utility.jl:331-467, definition/internal.jl:263-330).

All stored data is per-unit/radians; these settings only affect how values
passed to builder functions are interpreted and how reports are displayed.
A live prefix of 0.0 means "input already per-unit/radian" (no conversion),
matching the reference convention.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

SI_PREFIXES = {
    "q": 1e-30, "r": 1e-27, "y": 1e-24, "z": 1e-21, "a": 1e-18, "f": 1e-15,
    "p": 1e-12, "n": 1e-9, "u": 1e-6, "μ": 1e-6, "m": 1e-3, "c": 1e-2,
    "d": 1e-1, "da": 1e1, "h": 1e2, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12,
    "P": 1e15, "E": 1e18, "Z": 1e21, "Y": 1e24, "R": 1e27, "Q": 1e30,
}

# Allowed suffixes per quantity kind.
SUFFIXES = {
    "basePower": ["VA"],
    "baseVoltage": ["V"],
    "activePower": ["W", "pu"],
    "reactivePower": ["VAr", "pu"],
    "apparentPower": ["VA", "pu"],
    "voltageMagnitude": ["V", "pu"],
    "voltageAngle": ["deg", "rad"],
    "currentMagnitude": ["A", "pu"],
    "currentAngle": ["deg", "rad"],
    "impedance": ["Ω", "ohm", "pu"],
    "admittance": ["S", "pu"],
}


def parse_unit(unit: str, kind: str) -> tuple[str, float]:
    """Split ``unit`` into (suffix, prefix multiplier) for quantity ``kind``.

    Returns prefix 0.0 for "pu"/"rad" (per-unit convention: no conversion);
    for "deg" returns pi/180.
    """
    for suffix in sorted(SUFFIXES[kind], key=len, reverse=True):
        if unit.endswith(suffix):
            head = unit[: len(unit) - len(suffix)]
            if suffix in ("pu", "rad"):
                if head:
                    raise ValueError(f"prefix not allowed on '{suffix}'")
                return suffix, 0.0
            if suffix == "deg":
                if head:
                    raise ValueError("prefix not allowed on 'deg'")
                return suffix, math.pi / 180.0
            if not head:
                return suffix, 1.0
            if head in SI_PREFIXES:
                return suffix, SI_PREFIXES[head]
            raise ValueError(f"unknown SI prefix '{head}' in unit '{unit}'")
    raise ValueError(f"the unit '{unit}' is not valid for {kind}")


@dataclass
class UnitSystem:
    """Live input-unit state (the reference's ``unitList`` + ``pfx``)."""

    active_power: str = "pu"
    reactive_power: str = "pu"
    apparent_power: str = "pu"
    voltage_magnitude: str = "pu"
    voltage_angle: str = "rad"
    current_magnitude: str = "pu"
    current_angle: str = "rad"
    impedance: str = "pu"
    admittance: str = "pu"
    base_voltage_unit: str = "V"

    # live prefix multipliers (0.0 == per-unit input)
    pfx_active: float = 0.0
    pfx_reactive: float = 0.0
    pfx_apparent: float = 0.0
    pfx_voltage: float = 0.0
    pfx_angle: float = 0.0
    pfx_current: float = 0.0
    pfx_current_angle: float = 0.0
    pfx_impedance: float = 0.0
    pfx_admittance: float = 0.0
    pfx_base_voltage: float = 1.0

    def set_power(self, active: str = "pu", reactive: str = "pu",
                  apparent: str = "pu") -> None:
        """Reference ``@power(active, reactive, apparent)``."""
        _, self.pfx_active = parse_unit(active, "activePower")
        _, self.pfx_reactive = parse_unit(reactive, "reactivePower")
        _, self.pfx_apparent = parse_unit(apparent, "apparentPower")
        self.active_power, self.reactive_power, self.apparent_power = \
            active, reactive, apparent

    def set_voltage(self, magnitude: str = "pu", angle: str = "rad",
                    base: str = "V") -> None:
        """Reference ``@voltage(magnitude, angle, base)``."""
        _, self.pfx_voltage = parse_unit(magnitude, "voltageMagnitude")
        _, self.pfx_angle = parse_unit(angle, "voltageAngle")
        _, self.pfx_base_voltage = parse_unit(base, "baseVoltage")
        if self.pfx_base_voltage == 0.0:
            self.pfx_base_voltage = 1.0
        self.voltage_magnitude, self.voltage_angle = magnitude, angle
        self.base_voltage_unit = base

    def set_current(self, magnitude: str = "pu", angle: str = "rad") -> None:
        """Reference ``@current(magnitude, angle)``."""
        _, self.pfx_current = parse_unit(magnitude, "currentMagnitude")
        _, self.pfx_current_angle = parse_unit(angle, "currentAngle")
        self.current_magnitude, self.current_angle = magnitude, angle

    def set_parameter(self, impedance: str = "pu", admittance: str = "pu") -> None:
        """Reference ``@parameter(impedance, admittance)``."""
        _, self.pfx_impedance = parse_unit(impedance, "impedance")
        _, self.pfx_admittance = parse_unit(admittance, "admittance")
        self.impedance, self.admittance = impedance, admittance

    def reset(self) -> None:
        """Part of the reference ``@default(unit)`` macro."""
        self.__init__()


units = UnitSystem()


def topu(value, default, pfx_live: float, base_inv: float):
    """Convert an input value to per-unit (reference topu, utility.jl:331-354).

    ``default`` is a (value, is_pu) tuple used when ``value`` is None.
    ``pfx_live`` of 0.0 means the input is already per-unit.
    """
    if value is None:
        dval, dpu = default
        return dval if dpu else dval * base_inv
    if pfx_live != 0.0:
        return (value * pfx_live) * base_inv
    return float(value)


def base_impedance(base_voltage: float, base_power_inv: float,
                   turns_ratio: float, u: UnitSystem | None = None) -> float:
    """Reference baseImpedance (utility.jl:452-458)."""
    u = u or units
    if u.pfx_impedance != 0.0 or u.pfx_admittance != 0.0:
        return (base_voltage * turns_ratio) ** 2 * base_power_inv
    return 1.0


def base_current_inv(base_power_inv: float, base_voltage: float,
                     u: UnitSystem | None = None) -> float:
    """Reference baseCurrentInv (utility.jl:461-467)."""
    u = u or units
    if u.pfx_current != 0.0:
        return math.sqrt(3) * base_voltage * base_power_inv
    return 1.0
