#!/usr/bin/env python3
"""K2's layout choices swept on the card: panel width, threads a block and
the build's other options.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/k2_sweep.py [--reps 10] [--orders 28 60 236 256]

It first holds the package's kernel to ``chip_smoke.compare_k2``'s gates
(x within 1e-11 of max|x|, backward error 1e-14, info, getrf's pivots and
factors, two launches the same bits) on the seeded random inputs of
``chip_smoke.k2_random`` (LU: ``2 I + N(0, 1/n)`` with its rows shuffled,
so that every column pivots; Cholesky: ``m mᵀ / n + I``) at orders 1, 5,
28, 60, 236 and 256 and batches 1, 8 and 1,024. Then it builds
``csrc/fleet_solve.cu`` once for each variant in ``VARIANTS`` (the
layout's two defines: panel width ``FLEET_SOLVE_PANEL`` and threads a
block ``FLEET_SOLVE_THREADS``), one nvcc each, all started together, with
``-Xptxas -v`` (each mode's registers, spills and stack), requires every variant to give the package's bits at every
order and batch above, and times each variant in both modes at each of
``--orders`` on 1,024 scenarios (CUDA events, the variants in turns),
beside the library route (``lu_factor_ex`` + ``lu_solve``,
``cholesky_ex`` + ``cholesky_solve``) and ``torch.linalg.solve_ex``, with
the blocks an SM each variant gets (the occupancy query). The kernel has
one update order (right-looking) and no tensor-core update, so those are
not swept; other changes are measured with ``scripts/k2_timeline.py
--replace``. It ends with the card's ``nvidia-smi`` name and power limit and
exits non-zero on a failed check. About 60 s of command.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from juliagrid_tpu_torch.kernels import _build  # noqa: E402
from juliagrid_tpu_torch.kernels import fleet_solve as k2  # noqa: E402

#: each variant's defines on top of the source's defaults (panel 32, 128
#: threads)
VARIANTS = (
    {},
    {"FLEET_SOLVE_PANEL": 16},
    {"FLEET_SOLVE_THREADS": 256},
)
OUT = _build.BUILD_DIR.parent / "k2_sweep"


def ptxas_lines(stderr: str) -> str:
    return " ".join(line.strip() for line in stderr.splitlines()
                    if "registers" in line or "spill" in line
                    or "Compiling entry" in line)


def label(variant) -> str:
    return " ".join(f"{k[len('FLEET_SOLVE_'):].lower()}={v}"
                    for k, v in variant.items()) or "defaults"


def build(variant):
    """nvcc of ``csrc/fleet_solve.cu`` with the variant's defines into
    ``build/k2_sweep/``; the loaded library and ptxas's report."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / ("libk2_" + (label(variant).replace(" ", "_")
                             .replace("=", "")) + ".so")
    res = subprocess.run(
        [_build.nvcc_path(), *_build.nvcc_flags("fleet_solve"),
         *(f"-D{k}={v}" for k, v in variant.items()), "-Xptxas", "-v",
         "-o", str(lib), str(_build.CSRC / "fleet_solve.cu")],
        capture_output=True, text=True)
    cs.check(res.returncode == 0, f"nvcc {variant} failed:\n{res.stderr}")
    return k2.LIBRARY.bind(ctypes.CDLL(str(lib))), ptxas_lines(res.stderr)


def launch(dll, a, b, chol):
    """One launch of a built variant: x, info."""
    bsz, n = a.shape[:2]
    config = (ctypes.c_int * 3)()
    dll.fleet_solve_config(config)
    x = torch.empty(bsz, n, dtype=torch.float64, device=a.device)
    info = torch.empty(bsz, dtype=torch.int32, device=a.device)
    work = torch.empty_like(a) if n > config[1] else None
    err = dll.fleet_solve_launch(
        a.data_ptr(), b.data_ptr(), x.data_ptr(), info.data_ptr(),
        None if work is None else work.data_ptr(), None, bsz, n, 0,
        int(chol), 0, torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"a variant's launch failed: {err}")
    return x, info


def inputs(n, batch, chol):
    """``chip_smoke.k2_random``'s inputs, seeded by the order."""
    return cs.k2_random(n, batch, chol, cs.K2_CAP_SEED + n)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--orders", type=int, nargs="+",
                        default=[28, 60, 236, 256])
    args = parser.parse_args()
    cs.check(torch.cuda.is_available(), "no card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    for variant, (_, ptxas) in zip(VARIANTS, built):
        print(f"variant {label(variant)}: ptxas {ptxas}", flush=True)
    for n in (1, 5, 28, 60, 236, 256):
        for batch in (1, 8, 1024):
            for chol in (False, True):
                a, b = inputs(n, batch, chol)
                cs.compare_k2("random", chol, a, b, "k2_sweep")
                x = k2.fleet_cholesky_solve(a, b)[0] if chol else \
                    k2.fleet_lu_solve(a, b)[0]
                for variant, (dll, _) in zip(VARIANTS, built):
                    cs.check(cs.same_bits_of(launch(dll, a, b, chol)[0], x),
                             f"n={n} B={batch}: variant {label(variant)} "
                             "gives other bits")
        print(f"  order {n}: every variant the package's bits", flush=True)
    for n in args.orders:
        for chol in (False, True):
            a, b = inputs(n, 1024, chol)
            plain = cs.k2_pair(chol)[1]
            parts = []
            for variant, (dll, _) in zip(VARIANTS, built):
                ms = cs.cuda_ms(lambda: launch(dll, a, b, chol), args.reps)
                held = dll.fleet_solve_blocks_per_sm(n, int(chol), 0)
                parts.append(f"[{label(variant)}] {ms!r} ms ({held} an "
                             "SM)")
            lib_ms = cs.cuda_ms(lambda: plain(a, b), args.reps)
            ex_ms = cs.cuda_ms(lambda: torch.linalg.solve_ex(a, b),
                               args.reps)
            print(f"{'Cholesky' if chol else 'LU'} n={n} x1024: "
                  + ", ".join(parts) + f"; library route {lib_ms!r} ms, "
                  f"solve_ex {ex_ms!r} ms", flush=True)
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
