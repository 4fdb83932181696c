#!/usr/bin/env python3
"""What one K4 launch costs the stepwise Gauss-Seidel API.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/gs_launch.py [--root DIR]

``--root`` names the checkout whose ``juliagrid_tpu_torch`` is timed (this
one by default), so that two versions of the package are timed by the same
script in one process each. For case14test, case30test and case118 it
prints, for a one-sweep ``gs_sweep`` call from the flat start:

- ``lone``: CUDA events around 200 calls made one after another (the host's
  launch path in each), the median ms of five such runs;
- ``host``: the host's µs per call while the card is held busy by a sleep
  kernel, so that no call waits for the card;
- ``sync``: the wall µs of one call and a wait for the card, the median
  of 200: what a call whose result is read back waits;
- ``step``: the wall ms of one iteration of the reference's loop,
  ``gs_mismatch`` then ``gs_solve_step`` (two launches, two readbacks),
  the median of 100 iterations;

then the card's ``nvidia-smi`` name and power limit. ``--cluster C``
launches K4 as a cluster of C blocks in ``lone``, ``host`` and ``sync``
(through ``_launch``, which the package before the level-scheduled K4 does
not have).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

CASES = ("case14test", "case30test", "case118")
CALLS = 200
STEPS = 100


def lone_ms(fn) -> float:
    runs = []
    for _ in range(5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / CALLS)
    return statistics.median(runs)


def host_us(fn) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000 * CALLS)   # ~0.1 ms of the card's clock a call
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / CALLS


def sync_us(fn) -> float:
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return 1e6 * statistics.median(walls)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--cluster", type=int, default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import juliagrid_tpu_torch as jgt
    from juliagrid_tpu_torch.kernels import gs_sweep as k4
    from juliagrid_tpu_torch.powerflow import gauss_seidel as gs

    for case in CASES:
        path = str(args.root / "tests" / "data" / f"{case}.m")
        pf = gs.gauss_seidel(jgt.power_system(path), device="cuda")
        vre, vim = gs._to_rect(*pf._state())

        def one():
            if args.cluster is None:
                return k4.gs_sweep(pf.arrays, vre, vim)
            return k4._launch(pf.arrays, vre, vim, 1, 0.0, args.cluster)

        lone, host, sync = lone_ms(one), host_us(one), sync_us(one)
        walls = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            gs.gs_mismatch(pf)
            gs.gs_solve_step(pf)
            walls.append(time.perf_counter() - t0)
        print(f"{case}: lone {lone!r} ms, host {host!r} us, sync "
              f"{sync!r} us, step {1e3 * statistics.median(walls)!r} ms "
              f"({args.root}, cluster {args.cluster or 'picked'})",
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
