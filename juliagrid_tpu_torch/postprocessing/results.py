"""Result containers shared by all analyses (reference Cartesian/Polar
registries in definition/internal.jl:2-110)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Cartesian:
    active: np.ndarray = field(default_factory=lambda: np.empty(0))
    reactive: np.ndarray = field(default_factory=lambda: np.empty(0))


@dataclass
class PolarResult:
    magnitude: np.ndarray = field(default_factory=lambda: np.empty(0))
    angle: np.ndarray = field(default_factory=lambda: np.empty(0))


@dataclass
class AcPower:
    injection: Cartesian = field(default_factory=Cartesian)
    supply: Cartesian = field(default_factory=Cartesian)
    shunt: Cartesian = field(default_factory=Cartesian)
    from_: Cartesian = field(default_factory=Cartesian)
    to: Cartesian = field(default_factory=Cartesian)
    charging: Cartesian = field(default_factory=Cartesian)
    series: Cartesian = field(default_factory=Cartesian)
    generator: Cartesian = field(default_factory=Cartesian)


@dataclass
class AcCurrent:
    injection: PolarResult = field(default_factory=PolarResult)
    from_: PolarResult = field(default_factory=PolarResult)
    to: PolarResult = field(default_factory=PolarResult)
    series: PolarResult = field(default_factory=PolarResult)


@dataclass
class DcPower:
    injection: Cartesian = field(default_factory=Cartesian)
    supply: Cartesian = field(default_factory=Cartesian)
    from_: Cartesian = field(default_factory=Cartesian)
    to: Cartesian = field(default_factory=Cartesian)
    generator: Cartesian = field(default_factory=Cartesian)
