#!/usr/bin/env python3
"""K4's time per Gauss-Seidel sweep by cluster size and voltage layout.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/gs_cluster.py

For case118, the 10k lattice ``synthetic_grid(100, 100)`` and the 25k
lattice ``synthetic_grid(158, 158)`` it launches K4 with every cluster size
of 1, 2, 4, 8 and 16 blocks (and the size ``cluster_layout`` picks), the
voltage replicated in every block where it fits one and distributed over
the blocks, from the same random state. Each run must give the bits of the
default choice. It prints, for each, the device time of a launch of
``--sweeps`` sweeps less a launch of the mismatch alone (CUDA events, the
launches queued behind a sleep kernel: ``chip_smoke.queued_ms``), per
sweep and per level, then the card's ``nvidia-smi`` name and power limit,
and exits non-zero on a failed check or a launch that fails.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from juliagrid_tpu_torch.kernels import gs_sweep as k4  # noqa: E402
from juliagrid_tpu_torch.powerflow.gauss_seidel import (  # noqa: E402
    compile_gs_arrays)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweeps", type=int, default=20)
    args = parser.parse_args()
    card = cs.phase0()
    rng = np.random.default_rng(cs.SEED)
    room = k4.LIBRARY.load().gs_sweep_room(0)
    for case in ("case118", "10k grid", "25k grid"):
        arr = compile_gs_arrays(cs.case_system(case), "cuda")
        n = arr.bus_type.numel()
        vm = 1.0 + 0.05 * rng.standard_normal(n)
        va = 0.1 * rng.standard_normal(n)
        state = [torch.tensor(x, device="cuda")
                 for x in (vm * np.cos(va), vm * np.sin(va))]
        nlev = cs.levels(arr)
        pick = k4.cluster_layout(n, arr.widest, nlev, room)
        want = k4.gs_sweep(arr, *state, max_sweeps=args.sweeps)
        mis_ms = cs.queued_ms(lambda: k4.gs_sweep(arr, *state,
                                                  max_sweeps=0), reps=10)
        for cluster in sorted({1, 2, 4, 8, 16, pick[0]}):
            for distributed in (False, True):
                try:
                    k4.cluster_layout(n, arr.widest, nlev, room, cluster,
                                      distributed)
                except ValueError:
                    continue   # the voltage does not fit this layout

                def run(c=cluster, d=distributed):
                    return k4._launch(arr, *state, args.sweeps, 0.0, c, d)

                cs.check(cs.k4_same(run(), want),
                         f"{case}: cluster {cluster} distributed "
                         f"{distributed} differs from the default")
                ms = cs.queued_ms(run, reps=3)
                sweep_us = 1e3 * (ms - mis_ms) / args.sweeps
                mark = " (picked)" if (cluster, distributed) == pick else ""
                print(f"{case} n={n} {nlev} levels (widest {arr.widest}): "
                      f"cluster {cluster} "
                      f"{'distributed' if distributed else 'replicated'}"
                      f"{mark}: {sweep_us!r} us a sweep, "
                      f"{sweep_us / nlev!r} us a level (mismatch alone "
                      f"{mis_ms!r} ms)", flush=True)
    print(card)


if __name__ == "__main__":
    try:
        main()
    except cs.SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
