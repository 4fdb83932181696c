#!/usr/bin/env python3
"""Where a K2 launch spends one scenario's time, phase by phase.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/k2_timeline.py [--n 236] [--batch 1024] [--reps 10]
                                   [--cluster C] [--replace OLD NEW ...]

It builds a copy of ``csrc/fleet_solve.cu`` into ``build/k2_timeline/``
with ``FLEET_SOLVE_TIMELINE`` defined, so that thread 0 of every block of
one scenario stamps ``%globaltimer`` (the card's nanosecond clock, shared
by all SMs) at the end of each phase of the launch, after applying each
``--replace OLD NEW`` to the source (a variant to measure; every OLD must
occur). For each mode (LU, Cholesky) on inputs from a seeded generator
(those of ``scripts/k2_cluster.py``) at order ``--n``, with the planner's
cluster size or ``--cluster``, it launches one
scenario alone and then ``--batch`` scenarios, stamping the middle one,
and prints per block the µs of: the load of its columns, panel 0's
factorization, its waits at the panels' cluster barriers, the copies of
other blocks' panels, the row swaps, the look-ahead (the next panel's
columns updated and factored, in the block that owns it), the other U12
and trailing updates, the back substitution's waits and solves, and the
whole span.
Then the device ms of a ``--batch`` launch of the copy beside the
package's own kernel (CUDA events), whether the copy gives the package's
bits, ptxas's registers and spills of the copy, and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from juliagrid_tpu_torch.kernels import _build  # noqa: E402
from juliagrid_tpu_torch.kernels import fleet_solve as k2  # noqa: E402
from scripts.k2_cluster import inputs  # noqa: E402

STAMPS = 192
MAX_CLUSTER = 8
OUT = _build.BUILD_DIR.parent / "k2_timeline"


def build(replace) -> tuple:
    src = (_build.CSRC / "fleet_solve.cu").read_text()
    for old, new in replace:
        cs.check(old in src, f"--replace: {old!r} is not in the source")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "fleet_solve.cu"
    path.write_text(src)
    lib = OUT / "libk2_timeline.so"
    res = subprocess.run(
        [_build.nvcc_path(), *_build.nvcc_flags("fleet_solve"),
         "-DFLEET_SOLVE_TIMELINE", "-Xptxas", "-v", "-o", str(lib),
         str(path)], capture_output=True, text=True)
    cs.check(res.returncode == 0, f"nvcc failed:\n{res.stderr}")
    ptxas = " ".join(line.strip() for line in res.stderr.splitlines()
                     if "registers" in line or "spill" in line)
    dll = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dll.fleet_solve_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    dll.fleet_solve_launch.restype = i32
    dll.fleet_solve_timeline.argtypes = [ctypes.c_longlong, ptr, ptr]
    dll.fleet_solve_timeline.restype = i32
    return dll, ptxas


def launch(dll, a, b, chol, cluster):
    bsz, n = a.shape[:2]
    x = torch.empty(bsz, n, dtype=torch.float64, device="cuda")
    info = torch.empty(bsz, dtype=torch.int32, device="cuda")
    err = dll.fleet_solve_launch(
        a.data_ptr(), b.data_ptr(), x.data_ptr(), info.data_ptr(), None,
        None, bsz, n, cluster, int(chol), 0,
        torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"the stamped copy failed to launch: {err}")
    return x, info


def stamps(dll, scenario):
    """The last launch's phase stamps ``[MAX_CLUSTER, STAMPS]`` and column
    stamps ``[MAX_N, 4]`` (ns and clock after each column's barrier and
    after its update)."""
    out = np.zeros(MAX_CLUSTER * STAMPS, dtype=np.uint64)
    cols = np.zeros(k2.CAP * 4, dtype=np.uint64)
    torch.cuda.synchronize()
    cs.check(dll.fleet_solve_timeline(scenario, out.ctypes.data,
                                      cols.ctypes.data) == 0,
             "reading the stamps failed")
    return (out.reshape(MAX_CLUSTER, STAMPS).astype(np.int64),
            cols.reshape(k2.CAP, 4).astype(np.int64))


def report_columns(cols, n):
    """Panel 0's columns: ns from one column's barrier to the next, of it
    the barrier to the end of the update, and the SM clock's rate."""
    k = min(n, k2.PANEL)
    step = np.diff(cols[:k, 0]) / 1e3
    body = (cols[:k, 2] - cols[:k, 0]) / 1e3
    ghz = (cols[k - 1, 3] - cols[0, 1]) / max(cols[k - 1, 2] - cols[0, 0], 1)
    print(f"  panel 0 columns: barrier to barrier {np.round(step, 3)} us, "
          f"barrier to the update's end {np.round(body, 3)} us; SM clock "
          f"{ghz!r} GHz")


def report(label, t, n, cluster):
    """Per block: the phases' µs from its stamps (see csrc's stamp()
    calls: its start; after the load; after panel 0's factorization (block
    0); per panel before and after the barrier's wait, after the copy,
    after the swaps, after the look-ahead (the next panel's columns and its
    factorization, where the block owns it) and after the other updates;
    per back-substitution panel after the barrier and after the solve; the
    end), and the span from the first block's start to the last end."""
    panels = -(-n // k2.PANEL)
    last = 3 + 8 * panels
    span = (t[:cluster, last].max() - t[:cluster, 0].min()) / 1e3
    print(f"{label}: span {span!r} us")
    for r in range(cluster):
        row = t[r]
        sums = dict.fromkeys(("load", "factor", "wait", "copy", "swaps",
                              "ahead", "update", "bwait", "bsolve"), 0.0)
        sums["load"] = (row[1] - row[0]) / 1e3
        sums["factor"] = (row[2] - row[1]) / 1e3
        prev = row[2]
        for p in range(panels):
            e = 3 + 6 * p
            sums["update"] += (row[e] - prev) / 1e3
            sums["wait"] += (row[e + 1] - row[e]) / 1e3
            sums["copy"] += (row[e + 2] - row[e + 1]) / 1e3
            sums["swaps"] += (row[e + 3] - row[e + 2]) / 1e3
            sums["ahead"] += (row[e + 4] - row[e + 3]) / 1e3
            sums["update"] += (row[e + 5] - row[e + 4]) / 1e3
            prev = row[e + 5]
        e = 3 + 6 * panels
        for p in range(panels):
            sums["bwait"] += (row[e] - prev) / 1e3
            sums["bsolve"] += (row[e + 1] - row[e]) / 1e3
            prev = row[e + 1]
            e += 2
        print(f"  block {r}: " + ", ".join(f"{k} {v!r}"
                                          for k, v in sums.items())
              + f", end {(row[e] - prev) / 1e3!r} us")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=236)
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--cluster", type=int, default=None)
    parser.add_argument("--replace", nargs=2, action="append", default=[],
                        metavar=("OLD", "NEW"))
    args = parser.parse_args()
    cs.check(torch.cuda.is_available(), "no card")
    dll, ptxas = build(args.replace)
    print(f"ptxas (stamped copy): {ptxas}")
    plan = k2.fleet_plan(args.n, k2._library().fleet_solve_room(0),
                         args.cluster)
    for chol in (False, True):
        mode = "Cholesky" if chol else "LU"
        a, b = inputs(args.n, args.batch, chol)
        for batch, scenario in ((1, 0), (args.batch, args.batch // 2)):
            stamps(dll, scenario)
            launch(dll, a[:batch].contiguous(), b[:batch].contiguous(),
                   chol, plan.cluster)
            t, cols = stamps(dll, -1)
            report(f"{mode} n={args.n} B={batch} scenario {scenario} "
                   f"({plan.cluster}-block cluster)", t, args.n,
                   plan.cluster)
            report_columns(cols, args.n)
        mine, _ = launch(dll, a, b, chol, plan.cluster)
        theirs, _ = k2._launch(a, b, None, None, chol, plan.cluster)
        ms = cs.cuda_ms(lambda: launch(dll, a, b, chol, plan.cluster),
                        args.reps)
        base = cs.cuda_ms(lambda: k2._launch(a, b, None, None, chol,
                                             plan.cluster), args.reps)
        print(f"{mode} n={args.n} x{args.batch}: stamped copy {ms!r} ms, "
              f"the package's kernel {base!r} ms; same bits "
              f"{bool(torch.equal(mine, theirs))}")
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
