#!/usr/bin/env python3
"""BBD Newton-Raphson of one large synthetic lattice on the card.

Run from the root of a checkout:

    python3 scripts/bbd_scale.py --rows 265 --cols 265 --blocks 96 \
        --iterations 40

It builds the kernels as ``chip_smoke.py`` does, times ``synthetic_grid``
and the scipy ``oracle_nr``, then drives ``newton_raphson_bbd`` ->
``power_flow_bbd`` through ``chip_smoke.nr_bbd_run``, both capped at
``--iterations`` (40, as ``benchmarks/scale_25k.py`` runs the JAX
package): the oracle's iterations and convergence, states within 1e-8 of
it where it converged, the host build time, the CUDA-event split of an
iteration and the peak device memory. It prints the card's
``nvidia-smi`` name and power limit last and exits non-zero on a failed
check. The default lattice has 70,225 buses, whose dense Newton-Raphson
Jacobian (157 GB) no card holds.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from juliagrid_tpu_torch.oracle import oracle_nr  # noqa: E402
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=265)
    parser.add_argument("--cols", type=int, default=265)
    parser.add_argument("--blocks", type=int, default=96)
    parser.add_argument("--iterations", type=int, default=40)
    args = parser.parse_args()
    card = cs.phase0()
    t_system, system = cs.wall_s(lambda: synthetic_grid(args.rows,
                                                        args.cols))
    t_oracle, oracle = cs.wall_s(lambda: oracle_nr(
        system, iteration=args.iterations))
    label = f"{args.rows}x{args.cols}"
    print(f"{label} grid: n={system.bus.number}, {system.branch.number} "
          f"branches; power_system {t_system!r} s; oracle_nr "
          f"{oracle.iterations} iterations in {t_oracle!r} s, converged "
          f"{oracle.converged}, max mismatch {oracle.max_mismatch_active!r} "
          f"/ {oracle.max_mismatch_reactive!r}")
    cs.nr_bbd_run(label, system, oracle, cs.GRID_STATE_TOL, args.blocks,
                  args.iterations, oracle.converged)
    print(card)


if __name__ == "__main__":
    try:
        main()
    except cs.SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
