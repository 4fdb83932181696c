#!/usr/bin/env python3
"""Where a K2 launch spends its time: the phases of every block of one SM.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/k2_timeline.py [--n 236] [--batch 1024] [--reps 10]
                                   [--define NAME=VALUE ...]
                                   [--replace OLD NEW ...]

It builds a copy of ``csrc/fleet_solve.cu`` into ``build/k2_timeline/``
with ``FLEET_SOLVE_TIMELINE`` defined, so that thread 0 of every block
stamps ``%globaltimer`` (the card's nanosecond clock, shared by all SMs) at
the end of each phase and records its SM, with each ``--define`` passed to
nvcc (a layout of ``scripts/k2_sweep.py``, such as
``FLEET_SOLVE_PANEL=16``) and each ``--replace OLD NEW`` applied to the
source (a variant to measure; every OLD must occur). For each mode (LU,
Cholesky) on the seeded inputs of ``scripts/k2_sweep.py`` at order
``--n`` it launches ``--batch`` scenarios and prints, for every block that
ran on the SM of block 0, in the order they started: its start and end in
µs from the launch's first stamp, and its time in each phase, summed over
the panels: staging a panel (and the wait for the block barrier after
it), factoring it (a block barrier a column), its trailing update as
thread 0's warp saw it (the panel's write, that warp's column groups),
the wait at the end-of-panel barrier for the block's other warps, and the
back substitution; for the LU above 128, each block's time split by the
layout's phases (the panels streamed through device memory, the handover:
the last streamed panel, whose update writes the on-chip matrix, the
panels factored on chip, the back substitution; ``first on-chip panel``
is ``fleet_plan``'s); and, for warp 0 of block 0, each panel's trailing
column groups split into the U12 gather and solve, the tile's loads and
update, and its stores. Then the span of the launch, the device ms of a
``--batch`` launch of the copy beside the package's kernel (CUDA events),
whether the copy gives the package's bits, ptxas's registers and spills of
the copy, and the card's ``nvidia-smi`` name and power limit. About 20 s.
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
from scripts.k2_sweep import inputs, launch, ptxas_lines  # noqa: E402

STAMPS = 96
STAMP_BLOCKS = 4096
GROUP_PANELS, GROUP_SLOTS, GROUP_STAMPS = 16, 16, 4
OUT = _build.BUILD_DIR.parent / "k2_timeline"


def build(defines, replace):
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
         "-DFLEET_SOLVE_TIMELINE", *(f"-D{d}" for d in defines), "-Xptxas",
         "-v", "-o", str(lib), str(path)], capture_output=True, text=True)
    cs.check(res.returncode == 0, f"nvcc failed:\n{res.stderr}")
    dll = k2.LIBRARY.bind(ctypes.CDLL(str(lib)))
    dll.fleet_solve_timeline.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.fleet_solve_timeline.restype = ctypes.c_int
    dll.fleet_solve_group_timeline.argtypes = [ctypes.c_void_p]
    dll.fleet_solve_group_timeline.restype = ctypes.c_int
    return dll, ptxas_lines(res.stderr)


def groups(dll, panels):
    """Block 0's warp 0, its trailing column groups of each panel: µs in
    the U12 gather and solve, the tile's loads and update, the stores, and
    between groups (the next group's start after this one's end)."""
    out = np.zeros(GROUP_PANELS * GROUP_SLOTS * GROUP_STAMPS,
                   dtype=np.uint64)
    cs.check(dll.fleet_solve_group_timeline(out.ctypes.data) == 0,
             "reading the group stamps failed")
    g = out.reshape(GROUP_PANELS, GROUP_SLOTS, GROUP_STAMPS).astype(np.int64)
    for p in range(min(panels, GROUP_PANELS)):
        rows = [g[p, i] for i in range(GROUP_SLOTS) if g[p, i, 3] > 0]
        if not rows:
            continue
        d = np.array([np.diff(r) for r in rows]) / 1e3
        print(f"  block 0 warp 0, panel {p}: {len(rows)} groups, mean us: "
              f"U12 gather+solve {d[:, 0].mean()!r}, tile loads+update "
              f"{d[:, 1].mean()!r}, stores {d[:, 2].mean()!r}")


def stamps(dll):
    """The last launch's stamps ``[STAMP_BLOCKS, STAMPS]`` (ns, 0 where
    none) and each block's SM; both are cleared for the next launch."""
    out = np.zeros(STAMP_BLOCKS * STAMPS, dtype=np.uint64)
    smid = np.zeros(STAMP_BLOCKS, dtype=np.int32)
    torch.cuda.synchronize()
    cs.check(dll.fleet_solve_timeline(out.ctypes.data, smid.ctypes.data)
             == 0, "reading the stamps failed")
    return out.reshape(STAMP_BLOCKS, STAMPS).astype(np.int64), smid


def phases(row, panels):
    """A block's µs by phase from its stamps (see the kernel's stamp()
    calls: its start; per panel after the staging barrier, after the
    factorization, after thread 0's warp's trailing groups, after the
    end-of-panel barrier; per back-substitution panel after its last
    barrier; the end)."""
    us = dict.fromkeys(("staging", "factor", "trailing", "wait", "backsub",
                        "end"), 0.0)
    prev = row[0]
    for p in range(panels):
        e = 1 + 4 * p
        us["staging"] += (row[e] - prev) / 1e3
        us["factor"] += (row[e + 1] - row[e]) / 1e3
        us["trailing"] += (row[e + 2] - row[e + 1]) / 1e3
        us["wait"] += (row[e + 3] - row[e + 2]) / 1e3
        prev = row[e + 3]
    back = 1 + 4 * panels + panels - 1
    us["backsub"] = (row[back] - prev) / 1e3
    us["end"] = (row[back + 1] - row[back]) / 1e3
    return us, row[back + 1]


def layout_phases(row, panels, first):
    """The wide LU's µs by the layout's phases: the panels streamed
    through device memory before the handover, the handover (panel first
    - 1), the panels factored on chip, and the back substitution."""
    us = dict.fromkeys(("streamed", "handover", "on-chip", "backsub"), 0.0)
    prev = row[0]
    for p in range(panels):
        end = row[4 + 4 * p]
        kind = ("on-chip" if p >= first else
                "handover" if p == first - 1 else "streamed")
        us[kind] += (end - prev) / 1e3
        prev = end
    us["backsub"] = (row[1 + 5 * panels] - prev) / 1e3
    return us


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=236)
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--define", action="append", default=[])
    parser.add_argument("--replace", nargs=2, action="append", default=[],
                        metavar=("OLD", "NEW"))
    args = parser.parse_args()
    cs.check(torch.cuda.is_available(), "no card")
    cs.check(args.batch <= STAMP_BLOCKS, f"--batch above {STAMP_BLOCKS}")
    dll, ptxas = build(args.define, args.replace)
    print(f"ptxas (stamped copy): {ptxas}")
    config = (ctypes.c_int * 3)()
    dll.fleet_solve_config(config)
    panels = -(-args.n // config[1])
    for chol in (False, True):
        mode = "Cholesky" if chol else "LU"
        first = ctypes.c_int()
        dll.fleet_solve_shared_bytes(args.n, int(chol),
                                     dll.fleet_solve_room(0),
                                     ctypes.byref(first))
        wide = first.value < panels
        a, b = inputs(args.n, args.batch, chol)
        launch(dll, a, b, chol)
        stamps(dll)
        mine, _ = launch(dll, a, b, chol)
        t, smid = stamps(dll)
        t = t[:args.batch]
        origin = t[:, 0].min()
        blocks = np.nonzero(smid[:args.batch] == smid[0])[0]
        blocks = blocks[np.argsort(t[blocks, 0])]
        print(f"{mode} n={args.n} B={args.batch} (panel {config[1]}, "
              f"{config[0]} threads): {len(blocks)} blocks ran on SM "
              f"{smid[0]}; launch span "
              f"{(t[:, 1 + 5 * panels].max() - origin) / 1e3!r} us")
        for blk in blocks:
            us, end = phases(t[blk], panels)
            print(f"  block {blk}: {(t[blk, 0] - origin) / 1e3!r} to "
                  f"{(end - origin) / 1e3!r} us; "
                  + ", ".join(f"{k} {v!r}" for k, v in us.items()))
            if wide:
                print("    by the layout: " + ", ".join(
                    f"{k} {v!r}" for k, v in layout_phases(
                        t[blk], panels, first.value).items()))
        groups(dll, panels)
        totals = [phases(t[blk], panels)[0] for blk in range(args.batch)]
        print(f"  every block, mean us: " + ", ".join(
            f"{k} {np.mean([u[k] for u in totals])!r}" for k in totals[0]))
        if wide:
            split = [layout_phases(t[blk], panels, first.value)
                     for blk in range(args.batch)]
            print(f"  every block by the layout (first on-chip panel "
                  f"{first.value} of {panels}), mean us: " + ", ".join(
                      f"{k} {np.mean([u[k] for u in split])!r}"
                      for k in split[0]))
        theirs = (k2.fleet_cholesky_solve if chol else k2.fleet_lu_solve)(
            a, b)[0]
        ms = cs.cuda_ms(lambda: launch(dll, a, b, chol), args.reps)
        base = cs.cuda_ms(lambda: k2._launch(a, b, None, None, chol),
                          args.reps)
        print(f"{mode} n={args.n} x{args.batch}: stamped copy {ms!r} ms, "
              f"the package's kernel {base!r} ms; same bits "
              f"{cs.same_bits_of(mine, theirs)}", flush=True)
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
