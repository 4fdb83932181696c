#!/usr/bin/env python3
"""K2's time by cluster size, beside the library calls, at the fleets' orders.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/k2_cluster.py [--reps 10]

It builds ``csrc/fleet_solve.cu`` with ``-Xptxas -v`` (printing each
kernel's registers, spills and shared memory), then, on the seeded random
inputs of ``chip_smoke.k2_random`` (LU: ``2 I + N(0, 1/n)`` with its rows
shuffled, so that every column pivots; Cholesky: ``m mᵀ / n + I``), holds
both modes to ``chip_smoke.compare_k2``'s gates (x within 1e-11 of
max|x|, backward error 1e-14, info, getrf's pivots and factors, two
launches the same bits) at orders 1, 5, 28, 60, 236 and 256 and batches
1, 8 and 1,024, and every cluster size that fits to the same bits. Then it
times each mode at orders 28, 60, 236 and 256 on 1,024 scenarios for every
cluster size that fits (CUDA events), beside the library route
(``lu_factor_ex`` + ``lu_solve``, ``cholesky_ex`` + ``cholesky_solve``),
with the clusters the card holds at once. It ends with the card's
``nvidia-smi`` name and power limit and exits non-zero on a failed
check.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from juliagrid_tpu_torch.kernels import _build  # noqa: E402
from juliagrid_tpu_torch.kernels import fleet_solve as k2  # noqa: E402


def ptxas_report() -> str:
    out = _build.BUILD_DIR / "fleet_solve_ptxas.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [_build.nvcc_path(), *_build.nvcc_flags("fleet_solve"), "-Xptxas",
         "-v", "-o", str(out), str(_build.CSRC / "fleet_solve.cu")],
        capture_output=True, text=True)
    cs.check(res.returncode == 0, f"nvcc failed:\n{res.stderr}")
    return " ".join(line.strip() for line in res.stderr.splitlines()
                    if "registers" in line or "spill" in line)


def inputs(n, batch, chol):
    """``chip_smoke.k2_random``'s inputs, seeded by the order."""
    return cs.k2_random(n, batch, chol, cs.K2_CAP_SEED + n)


def fits(n):
    room = k2._library().fleet_solve_room(0)
    return [c for c in k2.CLUSTERS if k2.shared_bytes(n, c) <= room]


def check_mode(n, batch, chol):
    """``chip_smoke.compare_k2``'s gates, then every cluster size that fits
    the same bits."""
    a, b = inputs(n, batch, chol)
    cs.compare_k2("random", chol, a, b, "k2_cluster")
    x = cs.k2_pair(chol)[0](a, b)[0]
    for cluster in fits(n):
        other, _ = k2._launch(a, b, None, None, chol, cluster=cluster)
        cs.check(torch.equal(other, x), f"n={n} B={batch}: a "
                 f"{cluster}-block cluster gives other bits")
    print(f"  clusters {fits(n)} the same bits", flush=True)


def times(n, chol, reps):
    a, b = inputs(n, 1024, chol)
    plain = cs.k2_pair(chol)[1]
    parts = []
    for cluster in fits(n):
        ms = cs.cuda_ms(lambda: k2._launch(a, b, None, None, chol,
                                           cluster=cluster), reps)
        held = k2.active_clusters(n, cluster, chol)
        parts.append(f"{cluster} blocks {ms!r} ms ({held} clusters at "
                     "once)")
    lib_ms = cs.cuda_ms(lambda: plain(a, b), reps)
    print(f"{'Cholesky' if chol else 'LU'} n={n} x1024: K2 "
          + ", ".join(parts) + f"; library route {lib_ms!r} ms", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    cs.check(torch.cuda.is_available(), "no card")
    print("ptxas: " + ptxas_report(), flush=True)
    for n in (1, 5, 28, 60, 236, 256):
        for batch in (1, 8, 1024):
            for chol in (False, True):
                check_mode(n, batch, chol)
    for n in (28, 60, 236, 256):
        for chol in (False, True):
            times(n, chol, args.reps)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    try:
        main()
    except cs.SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
