#!/usr/bin/env python3
"""K8's two regimes and the two layouts of K3's entry mode timed at batches
around ``gain_fill.FLEET_MIN``, the threshold that chooses between them.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/k8_crossover.py [--reps 20]
                                    [--batches 4 8 16 24 32 48 64]

On the inputs ``chip_smoke.py`` makes from seeded generators (bench.py's
SCADA + PMU set, ``chip_smoke.scada_pmu``, on case118 and on the 37x37
grid of 1,369 buses) it runs, at each batch, the pair K3 entry mode + K8
both ways: the values row-major with K8's small-B regime, and the values
scenario-minor with K8's fleet regime (``FLEET_MIN`` set to above the
batch, then to 1, for the call). It checks that both ways give the same
bits of G and rhs, then times each kernel of each way with CUDA events
(device ms, the calls queued), the two ways in turns (small-B, fleet,
fleet, small-B), and prints the times and their sums. Last, the card's
``nvidia-smi`` name and power limit. About 60 s.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from juliagrid_tpu_torch.kernels import gain_fill as k8  # noqa: E402
from juliagrid_tpu_torch.kernels import se_fill as k3  # noqa: E402


@contextlib.contextmanager
def regime(fleet: bool, batch: int):
    """Inside the block, ``batch`` scenarios take the fleet regime and
    scenario-minor values if ``fleet``, else the small-B regime and
    row-major values."""
    saved = k8.FLEET_MIN
    k8.FLEET_MIN = 1 if fleet else batch + 1
    try:
        yield
    finally:
        k8.FLEET_MIN = saved


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--batches", type=int, nargs="+",
                        default=[4, 8, 16, 24, 32, 48, 64])
    args = parser.parse_args()
    cs.check(torch.cuda.is_available(), "no card")
    k3.LIBRARY.load()
    k8.LIBRARY.load()
    systems = (("case118", cs.power_system(str(cs.DATA / "case118.m"))),
               (f"{cs.SE_GRID[0]}x{cs.SE_GRID[1]}",
                cs.synthetic_grid(*cs.SE_GRID)))
    for label, system in systems:
        mon, pf = cs.scada_pmu(system)
        for batch in args.batches:
            rng = np.random.default_rng(cs.SEED)
            arr, net, _, (vm, va, mean) = cs.k3_inputs(system, mon, pf,
                                                       batch, rng)
            table = cs.gain_table(arr, net)
            vals, out = {}, {}
            for fleet in (False, True):
                with regime(fleet, batch):
                    res = k3.se_fill_entries(arr, net, vm, va, mean)
                    cs.check(res.vals.is_contiguous() != fleet,
                             f"{label} x{batch}: K3's layout was not forced")
                    vals[fleet] = res.vals
                    out[fleet] = k8.gain_fill(table, res.vals, arr.w,
                                              arr.pair_off, res.r)
            cs.check(cs.same_bits_of(vals[False], vals[True]) and all(
                cs.same_bits_of(a, b) for a, b in zip(out[False], out[True])),
                f"{label} x{batch}: the two ways' bits differ")
            r = res.r
            del out
            times = {False: ([], []), True: ([], [])}
            for fleet in (False, True, True, False):
                with regime(fleet, batch):
                    times[fleet][0].append(cs.queued_ms(
                        lambda: k3.se_fill_entries(arr, net, vm, va, mean),
                        args.reps))
                    v = vals[fleet]
                    times[fleet][1].append(cs.queued_ms(
                        lambda: k8.gain_fill(table, v, arr.w, arr.pair_off,
                                             r), args.reps))
            small, fleet = (tuple(map(min, times[f])) for f in (False, True))
            print(f"{label} x{batch} device ms in turns: K3 row-major "
                  f"{times[False][0]!r}, scenario-minor {times[True][0]!r}; "
                  f"K8 small-B {times[False][1]!r}, fleet {times[True][1]!r}; "
                  f"sums of the least small-B {sum(small)!r}, fleet "
                  f"{sum(fleet)!r}", flush=True)
            del vals, table, arr, net
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
