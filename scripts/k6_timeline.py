#!/usr/bin/env python3
"""Where K6's Hessian mode spends its time: a timeline of its blocks.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/k6_timeline.py [--seed S] [--launches L]

It builds a copy of ``csrc/opf_fill.cu`` into ``build/k6_timeline/`` with
``%globaltimer`` stamps (the card's nanosecond clock, shared by all SMs) at
each block's start, after each of a value group's passes and at each
block's end, and runs the Hessian of case1354pegase at a random point near
its start (``chip_smoke.k6_points``) ``L`` times, first with the zeros stored
(the real kernel's work) and then with the output zeroed by the caller, so
that only the values are stored. For each run it prints the kernel's span
(the last stamp less the first) and, by kind of block (value group, tail
unit, bus unit), the 0/10/50/90/100th percentiles of the blocks' starts,
durations and ends in us; for the value groups also of their passes;
then the device ms of the stamped copy and of the package's own kernel
(``chip_smoke.queued_ms``), whether both give the package's H bit for bit,
and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from juliagrid_tpu_torch.kernels import _build  # noqa: E402
from juliagrid_tpu_torch.kernels import opf_fill as k6  # noqa: E402

#: stamps a block: start, after the value passes, end; then one per pass
STAMPS = 8


def stamped_source():
    """csrc/opf_fill.cu with the stamps and an extern "C" reader, and how
    many of a value group's passes end at a stamp of their own."""
    src = (_build.CSRC / "opf_fill.cu").read_text()
    src = src.replace('#include "opf_terms.cuh"',
                      f'#include "{_build.CSRC / "opf_terms.cuh"}"')
    edits = [
        ("namespace {\n\nconstexpr int kWarp = 32;",
         f"__device__ unsigned long long g_stamp[{STAMPS} * 65536];\n"
         "__device__ __forceinline__ unsigned long long now() {\n"
         "  unsigned long long v;\n"
         '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(v));\n'
         "  return v;\n}\n\nnamespace {\n\nconstexpr int kWarp = 32;"),
        ("  const int64_t b = blockIdx.x;\n",
         "  const int64_t b = blockIdx.x;\n"
         f"  if (tid == 0) g_stamp[{STAMPS} * b] = now();\n"),
        ("    bus_values(t, x, y, z, out, view, room_bp, k0, k1, s0, s1, q0, "
         "q1);\n",
         "    bus_values(t, x, y, z, out, view, room_bp, k0, k1, s0, s1, q0, "
         "q1);\n    __syncthreads();\n"
         f"    if (tid == 0) g_stamp[{STAMPS} * b + 1] = now();\n"),
        ("    stream_zeros(out, bits, (n + k0) * nx, (n + k1) * nx, window, "
         "count, pos);\n  }\n}\n",
         "    stream_zeros(out, bits, (n + k0) * nx, (n + k1) * nx, window, "
         "count, pos);\n  }\n  __syncthreads();\n"
         f"  if (tid == 0) g_stamp[{STAMPS} * b + 2] = now();\n}}\n"),
    ]
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"opf_fill.cu no longer holds {old!r}")
        src = src.replace(old, new)
    # a stamp after each of the value passes' barriers
    head = src.index("__device__ void bus_values(")
    tail = src.index("// The cost's second derivative on the diagonal")
    body, count = src[head:tail], 0
    while "  __syncthreads();\n  for" in body:
        count += 1
        body = body.replace(
            "  __syncthreads();\n  for",
            "  __syncthreads();\n  if (threadIdx.x == 0) "
            f"g_stamp[{STAMPS} * blockIdx.x + {2 + count}] = now();\n  for",
            1)
    src = src[:head] + body + src[tail:]
    return src + ('\nextern "C" int stamps(void* dst) {\n'
                  "  return cudaMemcpyFromSymbol(dst, g_stamp, "
                  "sizeof(g_stamp));\n}\n"), count


def build():
    """The stamped copy's library and its count of pass stamps."""
    out = ROOT / "build" / "k6_timeline"
    out.mkdir(parents=True, exist_ok=True)
    src, count = stamped_source()
    (out / "opf_fill_stamped.cu").write_text(src)
    so = out / "libopf_fill_stamped.so"
    res = subprocess.run([_build.nvcc_path(), *_build.nvcc_flags("opf_fill"),
                          "-o", str(so), str(out / "opf_fill_stamped.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stderr)
    return k6.LIBRARY.bind(ctypes.CDLL(str(so))), count


def pct(a):
    return np.round(np.percentile(a, [0, 10, 50, 90, 100]) / 1e3, 3).tolist()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--launches", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no card: this script times the card")
    lib, count = build()
    system = cs.power_system(str(cs.DATA / cs.OPF_PEGASE))
    spec = cs.ac_optimal_power_flow(system, device="cuda")._spec
    arr = spec.arrays
    rng = np.random.default_rng(args.seed)
    x, y, z = (torch.as_tensor(a, device="cuda") for a in
               cs.k6_points(spec, spec.start(system), rng)[0])
    ref = k6.opf_fill(arr, x, y, z).hess
    entry = k6._tables(arr)
    out = torch.empty_like(ref)
    scratch = torch.empty(max(1, k6.scratch_doubles(arr.fill)),
                          dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    plan = arr.fill.hess_plan
    kinds = np.array([k for k, _ in k6.hess_blocks(plan, arr.n, arr.n_x)])
    print(f"case1354pegase: plan {tuple(plan)}, {kinds.size} blocks "
          f"({(kinds == 'value').sum()} value groups, "
          f"{(kinds == 'tail').sum()} tail units, {(kinds == 'bus').sum()} "
          f"bus units)")
    buf = (ctypes.c_ulonglong * (STAMPS * 65536))()

    def launch(zero):
        err = lib.opf_fill_launch(
            entry.address, x.data_ptr(), y.data_ptr(), z.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), 1, zero, *plan, stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    for zero in (1, 0):
        for run in range(args.launches):
            launch(zero)
            torch.cuda.synchronize()
            lib.stamps(buf)
            d = np.frombuffer(buf, dtype=np.uint64).reshape(-1, STAMPS)[
                :kinds.size].astype(np.int64)
            t0 = d[:, 0].min()
            start, mid, end = d[:, 0] - t0, d[:, 1] - t0, d[:, 2] - t0
            what = "values and zeros" if zero else "values alone"
            print(f"{what}, launch {run}: span {end.max() / 1e3:.3f} us")
            for kind in ("value", "tail", "bus"):
                m = kinds == kind
                print(f"  {kind}: start {pct(start[m])}, duration "
                      f"{pct((end - start)[m])}, end {pct(end[m])}")
            m = kinds == "value"
            passes = np.diff(np.column_stack([start[m], d[m, 3:3 + count]
                                              - t0, mid[m]]), axis=1)
            print(f"  value passes, from the block's start to each pass "
                  f"barrier and on to the last store (median us): "
                  f"{np.round(np.median(passes, axis=0) / 1e3, 3).tolist()}")
        if zero:
            print(f"  stamped copy gives the package's H: "
                  f"{torch.equal(out, ref)}")
    ms = cs.queued_ms(lambda: launch(1), 20)
    own = cs.queued_ms(lambda: k6.opf_fill(arr, x, y, z), 20)
    print(f"device ms a call: stamped copy {ms!r}, the package's {own!r}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
