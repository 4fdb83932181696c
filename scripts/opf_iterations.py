#!/usr/bin/env python3
"""DC OPF iteration counts of the JAX package and of the port, side by side.

Run from the root of a checkout, on the CPU (about a minute):

    JAX_PLATFORMS=cpu python3 scripts/opf_iterations.py [--lp] [case ...]

For each MATPOWER case of ``tests/data`` (default case14test, case30test
and case118) it solves the DC OPF with both packages' interior points and
prints each one's status, iterations, objective and seconds, and the
largest difference of angles and dispatch. With ``--lp`` every generator
first gets the distinct linear cost of ``tests/test_opf_anchor.py`` (seed
11), so the DC OPF is a linear program. The JAX package factors its KKT
systems in f32 with refinement and switches to an f64 LDLᵀ at its
precision wall; the port factors in f64 LU from the first iteration, so
the counts may differ while the solutions agree. This script imports the
JAX package, so it runs where that package does, not on the card's
machine.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import juliagrid_tpu as jg  # noqa: E402
import juliagrid_tpu_torch as jgt  # noqa: E402
from juliagrid_tpu.opf import dcopf as jax_dcopf  # noqa: E402
from juliagrid_tpu_torch.opf import dcopf  # noqa: E402


def linear_costs(pkg, system, seed=11):
    """tests/test_opf_anchor.py's rule: a distinct linear cost each."""
    rng = np.random.default_rng(seed)
    g = system.generator.number
    c1 = 20.0 + 30.0 * rng.random(g)
    for i in range(g):
        pkg.cost(system, system.generator.label.label(i), active=2,
                 polynomial=[float(c1[i]), 5.0])


def run(pkg, solve, path, lp, **dev):
    system = pkg.power_system(path)
    if lp:
        linear_costs(pkg, system)
    analysis = pkg.dc_optimal_power_flow(system, **dev)
    t0 = time.perf_counter()
    solve(analysis)
    return analysis, time.perf_counter() - t0


def main(args) -> None:
    lp = "--lp" in args
    cases = [a for a in args if a != "--lp"]
    for case in cases or ("case14test", "case30test", "case118"):
        path = str(ROOT / "tests" / "data" / f"{case}.m")
        ref, t_ref = run(jg, jax_dcopf.solve, path, lp)
        got, t_got = run(jgt, dcopf.solve, path, lp, device="cpu")
        dva = np.abs(got.voltage.angle - ref.voltage.angle).max()
        dpg = np.abs(got.power.generator.active
                     - ref.power.generator.active).max()
        for name, a, t in (("JAX", ref, t_ref), ("port", got, t_got)):
            r = a.method.result
            print(f"{case} {name}: {r.status}, {r.iterations} iterations, "
                  f"objective {r.objective!r}, {t:.2f} s")
        print(f"{case}: max |d theta| {dva:.3e}, max |d pg| {dpg:.3e}")


if __name__ == "__main__":
    main(sys.argv[1:])
