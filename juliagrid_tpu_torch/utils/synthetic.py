"""Synthetic power-system generator for benchmarking at arbitrary scale.

The reference's large cases (ACTIVSg25k/70k, SyntheticUSA 82k buses) ship as
stripped blobs, so scalability benchmarks here use synthetic grids: an
H x W lattice of buses with line parameters drawn from realistic ranges, a
generator on every k-th bus, and loads elsewhere. Deterministic per size.
"""

from __future__ import annotations

import numpy as np

from ..system.builders import add_branch, add_bus, add_generator
from ..system.load import power_system


def synthetic_grid(rows: int, cols: int, seed: int = 7, opf: bool = False):
    """Build a rows x cols lattice network; returns a PowerSystem.

    ``opf=True`` additionally attaches voltage bounds (0.9-1.1 pu) and
    deterministic quadratic generator costs so the case is a well-posed
    AC/DC OPF (the shape of the ACTIVSg synthetic fleet's cost data)."""
    rng = np.random.default_rng(seed)
    system = power_system()
    n = rows * cols

    vbound = {"min_magnitude": 0.9, "max_magnitude": 1.1} if opf else {}
    gen_every = 5
    for i in range(n):
        is_gen = i % gen_every == 0
        add_bus(system,
                label=i + 1,
                type=3 if i == 0 else (2 if is_gen else 1),
                active=0.0 if is_gen else float(rng.uniform(0.05, 0.3)),
                reactive=0.0 if is_gen else float(rng.uniform(0.01, 0.1)),
                magnitude=1.0,
                angle=0.0, **vbound)

    def bus_id(r, c):
        return r * cols + c + 1

    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                add_branch(system,
                           from_bus=bus_id(r, c), to_bus=bus_id(r, c + 1),
                           resistance=float(rng.uniform(0.01, 0.05)),
                           reactance=float(rng.uniform(0.05, 0.2)),
                           susceptance=float(rng.uniform(0.0, 0.04)))
            if r + 1 < rows:
                add_branch(system,
                           from_bus=bus_id(r, c), to_bus=bus_id(r + 1, c),
                           resistance=float(rng.uniform(0.01, 0.05)),
                           reactance=float(rng.uniform(0.05, 0.2)),
                           susceptance=float(rng.uniform(0.0, 0.04)))

    # transmission backbone: low-impedance long-range ties every 5 nodes
    # keep large lattices electrically stiff (real grids have an EHV layer;
    # without it NR diverges from flat start beyond ~2k buses)
    for r in range(0, rows, 5):
        for c in range(0, cols, 5):
            if c + 5 < cols:
                add_branch(system,
                           from_bus=bus_id(r, c), to_bus=bus_id(r, c + 5),
                           resistance=0.002, reactance=0.02)
            if r + 5 < rows:
                add_branch(system,
                           from_bus=bus_id(r, c), to_bus=bus_id(r + 5, c),
                           resistance=0.002, reactance=0.02)

    total_load = sum(system.bus.demand.active.array)
    n_gen = (n + gen_every - 1) // gen_every
    per_gen = 1.1 * total_load / n_gen
    for i in range(0, n, gen_every):
        add_generator(system,
                      bus=i + 1,
                      active=per_gen,
                      magnitude=1.02,
                      min_reactive=-3.0, max_reactive=3.0,
                      min_active=0.0, max_active=3.0 * per_gen)
    if opf:
        from ..system.builders import cost
        for j, i in enumerate(range(0, n, gen_every)):
            a = float(rng.uniform(0.02, 0.10))
            b = float(rng.uniform(15.0, 40.0))
            cost(system, j + 1, active=2, polynomial=[a, b, 0.0])
    return system
