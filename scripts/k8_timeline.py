#!/usr/bin/env python3
"""Where a K8 launch of the fleet regime spends its time, and build
variants of K8 and of K3's entry mode timed against the package's.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/k8_timeline.py [--reps 20] [--define NAME=VALUE ...]
                                   [--replace OLD NEW ...]
                                   [--k3-define NAME=VALUE ...]
                                   [--k3-replace OLD NEW ...]
                                   [--band-elements 1024]

It builds a copy of ``csrc/gain_fill.cu`` into ``build/k8_timeline/`` with
``GAIN_FILL_TIMELINE`` defined, so that thread 0 of each block of the
fleet regime stamps ``%globaltimer`` (the card's nanosecond clock, shared
by all SMs) when the block starts and when each of its phases ends (a
band's duplicate sums, its nonzeros' and rhs elements' sums, its stores)
and records its SM, with each ``--define`` passed to nvcc and each
``--replace OLD NEW`` applied to the source (every OLD must occur), so
that a variant of the kernel is timed against the package's. On the
seeded inputs of ``scripts/k8_pair.py`` at case118 x1024, x256 and the
37x37 grid x32 it checks that the copy gives the package's bits, times
the copy and the package's K8 in turns (CUDA events, device ms with the
calls queued), and prints from one stamped launch: the launch's span, the
blocks' mean and summed time in each phase, the most blocks resident on
an SM at once, and the share of the summed block time each phase takes.
It does the same for a copy of ``csrc/se_fill.cu`` built with
``SE_FILL_TIMELINE`` (each block of the scenario-minor entry mode stamps
its start, the end of its staging, of its rows and of its h and r
stores), with each ``--k3-define`` and ``--k3-replace``. ``--band-elements`` sets
``gain_fill.BAND_ELEMENTS`` (the G elements a band holds a scenario)
for the tables of both K8s. Then ptxas's registers and
spills of the copies, and the card's ``nvidia-smi`` name and power limit.
Last, K8's small-B regime at the 37x37 grid x1: each warp's span and the
time it spent forming and adding products, against its whole life (the
rest is its stores and searches). About 40 s.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from juliagrid_tpu_torch.kernels import _build  # noqa: E402
from juliagrid_tpu_torch.kernels import gain_fill as k8  # noqa: E402
from juliagrid_tpu_torch.kernels import se_fill as k3  # noqa: E402

OUT = _build.BUILD_DIR.parent / "k8_timeline"
STAMP_BLOCKS = 4096      # kStampBlocks of csrc/gain_fill.cu
WARP_STAMPS = 32768      # its kStampWarps
K3_STAMP_BLOCKS = 8192   # and of csrc/se_fill.cu


def build(name, defines, replace):
    """Build a copy of ``csrc/<name>.cu`` with ``defines`` and the
    ``replace`` edits; returns its CDLL, bound as the package binds the
    source, and ptxas's lines."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in replace:
        cs.check(old in src, f"--replace: {old!r} is not in {name}.cu")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    tag = "_".join(d.replace("=", "") for d in defines) or "base"
    path = OUT / f"{name}_{tag}.cu"
    path.write_text(src)
    lib = OUT / f"lib{name}_{tag}.so"
    res = subprocess.run(
        [_build.nvcc_path(), *_build.nvcc_flags(name),
         *(f"-D{d}" for d in defines), f"-I{_build.CSRC}", "-Xptxas", "-v",
         "-o", str(lib), str(path)], capture_output=True, text=True)
    cs.check(res.returncode == 0, f"nvcc failed:\n{res.stderr}")
    module = k8 if name == "gain_fill" else k3
    dll = module.LIBRARY.bind(ctypes.CDLL(str(lib)))
    ptxas = [line.strip() for line in res.stderr.splitlines()
             if "registers" in line or "spill" in line]
    return dll, ptxas


@contextlib.contextmanager
def using(module, dll):
    """Launch ``module``'s kernel from ``dll`` inside the block."""
    saved = module.LIBRARY.load()
    module.LIBRARY.dll = dll
    # the tables' structs do not depend on the library
    try:
        yield
    finally:
        module.LIBRARY.dll = saved


def timeline(module, dll, name, launch, blocks, width=5):
    """One stamped launch of ``module``'s copy ``dll`` (``launch()``): the
    ``width`` stamps of each of its first blocks (or warps), read by
    ``dll``'s function ``name``."""
    fn = getattr(dll, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    with using(module, dll):
        launch()
    torch.cuda.synchronize()
    stamps = np.zeros((blocks, width), dtype=np.uint64)
    cs.check(fn(stamps.ctypes.data, blocks) == 0, "reading the stamps failed")
    return stamps


def resident(starts, ends):
    """The most of the intervals [start, end) that overlap at once."""
    ev = np.concatenate([np.stack([starts, np.ones_like(starts)], 1),
                         np.stack([ends, -np.ones_like(ends)], 1)])
    ev = ev[np.lexsort((ev[:, 1], ev[:, 0]))]
    return int(np.cumsum(ev[:, 1]).max())


def report(label, stamps, blocks, names):
    st = stamps[:blocks].astype(np.int64)
    sm = st[:, 4]
    t0 = st[:, 0].min()
    span = (st[:, 3].max() - t0) / 1e3
    phases = {name: st[:, k + 1] - st[:, k] for k, name in enumerate(names)}
    total = sum(int(v.sum()) for v in phases.values())
    most = max(resident(st[sm == k, 0], st[sm == k, 3])
               for k in np.unique(sm))
    print(f"{label}: {blocks} blocks stamped, "
          f"span {float(span)!r} µs, at most {most} blocks on an SM; "
          + "; ".join(f"{k} mean {float(v.mean()) / 1e3!r} µs, "
                      f"{100 * float(v.sum()) / total!r}% of block time"
                      for k, v in phases.items()), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--define", action="append", default=[])
    parser.add_argument("--replace", nargs=2, action="append", default=[])
    parser.add_argument("--k3-define", action="append", default=[])
    parser.add_argument("--k3-replace", nargs=2, action="append", default=[])
    parser.add_argument("--band-elements", type=int,
                        default=k8.BAND_ELEMENTS)
    args = parser.parse_args()
    k8.BAND_ELEMENTS = args.band_elements
    cs.check(torch.cuda.is_available(), "no card")
    k8.LIBRARY.load()
    k3.LIBRARY.load()
    copy8, ptx8 = build("gain_fill", ["GAIN_FILL_TIMELINE", *args.define],
                        args.replace)
    copy3, ptx3 = build("se_fill", ["SE_FILL_TIMELINE", *args.k3_define],
                        args.k3_replace)
    case118 = cs.power_system(str(cs.DATA / "case118.m"))
    grid = cs.synthetic_grid(*cs.SE_GRID)
    for label, system, batch in (("case118 x1024", case118, cs.SE_FLEET),
                                 ("case118 x256", case118, cs.SE_FLEET // 4),
                                 ("37x37 x32", grid, cs.SE_CHUNK)):
        mon, pf = cs.scada_pmu(system)
        rng = np.random.default_rng(cs.SEED)
        arr, net, _, (vm, va, mean) = cs.k3_inputs(system, mon, pf, batch,
                                                   rng)
        res = k3.se_fill_entries(arr, net, vm, va, mean)
        with using(k3, copy3):
            alt = k3.se_fill_entries(arr, net, vm, va, mean)
        cs.check(all(cs.same_bits_of(getattr(res, f), getattr(alt, f))
                     for f in ("h", "r", "vals")),
                 f"{label}: the K3 copy's bits differ")
        del alt
        fn3 = lambda: k3.se_fill_entries(arr, net, vm, va,  # noqa: E731
                                         mean)
        times = {"package": [], "copy": []}
        for which in ("package", "copy", "copy", "package"):
            with using(k3, copy3) if which == "copy" else \
                    contextlib.nullcontext():
                times[which].append(cs.queued_ms(fn3, args.reps))
        print(f"{label} K3 entry mode device ms in turns: package "
              f"{times['package']!r}, copy {times['copy']!r}", flush=True)
        blocks = min(-(-batch // 32) * -(-arr.mean.shape[0] // 32),
                     K3_STAMP_BLOCKS)
        report(f"{label} K3 entry mode copy", timeline(
            k3, copy3, "se_fill_timeline", fn3, blocks), blocks,
            ("staging", "rows", "h and r"))
        table = cs.gain_table(arr, net)
        want = k8.gain_fill(table, res.vals, arr.w, arr.pair_off, res.r)
        with using(k8, copy8):
            got = k8.gain_fill(table, res.vals, arr.w, arr.pair_off, res.r)
        cs.check(all(cs.same_bits_of(a, b) for a, b in zip(want, got)),
                 f"{label}: the K8 copy's bits differ")
        del want, got
        fn = lambda: k8.gain_fill(table, res.vals, arr.w,  # noqa: E731
                                  arr.pair_off, res.r)
        times = {"package": [], "copy": []}
        for which in ("package", "copy", "copy", "package"):
            with using(k8, copy8) if which == "copy" else \
                    contextlib.nullcontext():
                times[which].append(cs.queued_ms(fn, args.reps))
        print(f"{label} K8 device ms in turns: package "
              f"{times['package']!r}, copy {times['copy']!r}", flush=True)
        band = k8.fleet_bands(table).band
        blocks = min(-(-batch // 32) * -(-table.n // band),
                     STAMP_BLOCKS)   # the band blocks
        report(f"{label} K8 copy", timeline(k8, copy8, "gain_fill_timeline",
                                            fn, blocks), blocks,
               ("duplicate sums", "nonzeros", "stores"))
        del res, table
        torch.cuda.empty_cache()
    # the small-B regime: the 1,369-bus set, one scenario
    mon, pf = cs.scada_pmu(grid)
    rng = np.random.default_rng(cs.SEED)
    arr, net, _, (vm, va, mean) = cs.k3_inputs(grid, mon, pf, 1, rng)
    res = k3.se_fill_entries(arr, net, vm, va, mean)
    table = cs.gain_table(arr, net)
    fn = lambda: k8.gain_fill(table, res.vals, arr.w,  # noqa: E731
                              arr.pair_off, res.r)
    want = fn()
    with using(k8, copy8):
        got = fn()
    cs.check(all(cs.same_bits_of(a, b) for a, b in zip(want, got)),
             "37x37 x1: the K8 copy's bits differ")
    times = {"package": [], "copy": []}
    for which in ("package", "copy", "copy", "package"):
        with using(k8, copy8) if which == "copy" else \
                contextlib.nullcontext():
            times[which].append(cs.queued_ms(fn, args.reps))
    print(f"37x37 x1 K8 device ms in turns: package {times['package']!r}, "
          f"copy {times['copy']!r}", flush=True)
    spans = -(-(-(-table.n // (64 if table.n % 2 == 0 else 32))) // 8)
    warps = min(table.n * (1 + spans), WARP_STAMPS)
    st = timeline(k8, copy8, "gain_fill_warp_timeline", fn, warps,
                  4).astype(np.int64)
    kind = st[:, 3] >> 16
    span = (st[:, 2].max() - st[:, 0].min()) / 1e3
    g_warps, r_warps = kind == 0, kind == 1
    life = st[:, 2] - st[:, 0]
    sm = st[:, 3] & 0xFFFF
    most = max(resident(st[sm == k, 0], st[sm == k, 2]) for k in np.unique(sm))
    busy = float(life.sum()) / (float(span) * 1e3 * len(np.unique(sm)))
    print(f"37x37 x1 K8 copy (small-B regime): at most {most} warps on an SM "
          f"at once, {busy!r} warps resident an SM on average over the "
          f"span; warps started by the span's quarters: "
          f"{np.histogram(st[:, 0], 4)[0].tolist()}", flush=True)
    print(f"37x37 x1 K8 copy (small-B regime): {warps} warps stamped, span "
          f"{float(span)!r} µs; a G span's warp {float(life[g_warps].mean())
          / 1e3!r} µs, of it forming and adding products (the duplicate "
          f"sums inside) {float(st[g_warps, 1].mean()) / 1e3!r} µs "
          f"({100 * float(st[g_warps, 1].sum() / life[g_warps].sum())!r}%), "
          f"the rest its stores and searches; an rhs warp "
          f"{float(life[r_warps].mean()) / 1e3!r} µs; the last warp ended "
          f"{float((st[:, 2].max() - st[g_warps, 2].max()) / 1e3)!r} µs "
          f"after the last G span", flush=True)
    print("K8 copy ptxas: " + " | ".join(ptx8))
    print("K3 copy ptxas: " + " | ".join(ptx3))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
