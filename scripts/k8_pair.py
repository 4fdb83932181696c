#!/usr/bin/env python3
"""K3's entry mode and K8 of one checkout timed at the main path's shapes,
for a before/after pair.

Run on a machine with one card, once for each checkout:

    python3 scripts/k8_pair.py --root DIR [--reps 20]

It imports the package and ``chip_smoke.py`` of the checkout under DIR
(so that an older tree, unpacked with ``git archive <sha> | tar -x -C
build/parent``, is measured by its own kernels), builds that tree's K3 and
K8 and times them with CUDA events on the inputs its ``chip_smoke.py``
makes from seeded generators: bench.py's SCADA + PMU set
(``chip_smoke.scada_pmu``) on case118 at 1,024 scenarios (the SE fleet) and
256 (a rank of the sharded fleet), on the 37x37 grid (1,369 buses) at 32
(a fleet chunk) and 1, and the 10k-bus DC set (one scenario, K8 alone).
Each line gives K3's entry mode and K8, each as the card's ms a call and
as device ms with the calls queued, beside the dense route they replaced
(K3's dense H; the rhs, W½ scaling and GEMM of ``chip_smoke.dense_ac_gain``),
the bound (K8: G and rhs written once, the values, weights, residuals and
the gain table's pattern arrays read once; K3: its inputs read and outputs
written once), and SHA-256 digests of the values, of G and of rhs, so that
two trees can be compared for the same bits. Then the host side: the
wall seconds of building the gain table anew (``chip_smoke.gain_table``:
the host tables, their checks and their copy to the card; the least and
the median of 5) for the case118 and 1,369-bus sets, and the live
measurement edits of ``chip_smoke.py``'s phase 19 (``se_edits``: a reused
and a fresh 1,369-bus estimate after each of two edits), run 3 times. Run
the trees in turns (parent, new, new, parent) in one call: times of one
card move between calls. About 80 s a tree.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np

#: the gain table's pattern arrays, the reads K8's bound counts in every
#: tree (a tree's own extra tables, such as band lists, are its kernel's)
K8_TABLES = ("nz_ptr", "nz_col", "c_ptr", "c_a", "c_b", "c_w", "dup_ptr",
             "dup_raw", "col_ptr", "col_ref", "col_row", "pair_of", "partner")


def digest(t) -> str:
    data = t.contiguous().cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from juliagrid_tpu_torch.kernels import _build
    from juliagrid_tpu_torch.kernels import gain_fill as k8
    from juliagrid_tpu_torch.kernels import se_fill as k3

    for mod in (k3, k8):
        cs.check(Path(mod.__file__).resolve().is_relative_to(root),
                 f"imported {mod.__file__}, not the tree under {root}")
    cs.check(torch.cuda.is_available(), "no card")
    _build.load_library("se_fill")
    _build.load_library("gain_fill")
    reps = args.reps

    def k8_line(label, table, vals, w, off, r, dense_ms):
        g, rhs = k8.gain_fill(table, vals, w, off, r)
        torch.cuda.synchronize()
        fn = lambda: k8.gain_fill(table, vals, w, off, r)  # noqa: E731
        ms = cs.cuda_ms(fn, reps)
        dev = cs.queued_ms(fn, reps)
        nbytes = 8 * g.numel() + 8 * rhs.numel() + cs.tensor_bytes(
            vals, w, off, r, *(getattr(table, f) for f in K8_TABLES))
        least = 1e3 * nbytes / cs.HBM_BYTES_PER_S
        print(f"{root.name} K8 {label}: {ms!r} ms, device {dev!r} ms, bound "
              f"{least!r} ms ({100 * least / dev!r}% of device), dense "
              f"route's gain {dense_ms!r} ms; G sha256 {digest(g)}, rhs "
              f"{digest(rhs)}", flush=True)
        del g, rhs

    def ac_cell(label, system, batch):
        mon, pf = cs.scada_pmu(system)
        rng = np.random.default_rng(cs.SEED)
        arr, net, _, (vm, va, mean) = cs.k3_inputs(system, mon, pf, batch,
                                                   rng)
        table = cs.gain_table(arr, net)
        res = k3.se_fill_entries(arr, net, vm, va, mean)
        fn = lambda: k3.se_fill_entries(arr, net, vm, va, mean)  # noqa: E731
        ms = cs.cuda_ms(fn, reps)
        dev = cs.queued_ms(fn, reps)
        dense_h = cs.cuda_ms(lambda: k3.se_fill(arr, net, vm, va, mean), 5)
        desc = arr.desc
        least = 1e3 * cs.tensor_bytes(
            desc.idx, desc.coef, desc.order, desc.epos, arr.status,
            net.row_ptr, net.cols, net.yg, net.yb, net.diag, vm, va, mean,
            *res) / cs.HBM_BYTES_PER_S
        print(f"{root.name} K3 entry mode {label}: {ms!r} ms, device {dev!r} "
              f"ms, bound {least!r} ms ({100 * least / dev!r}% of device), "
              f"K3's dense H {dense_h!r} ms; vals strides "
              f"{tuple(res.vals.stride())}, sha256 {digest(res.vals)}, h "
              f"{digest(res.h)}, r {digest(res.r)}", flush=True)
        dense = cs.dense_gain_ms(arr, net, vm, va, mean, 3)
        k8_line(label, table, res.vals, arr.w, arr.pair_off, res.r, dense)
        if batch == 1 or batch == cs.SE_FLEET:   # one a set: the host side
            walls = []
            for _ in range(5):
                k8._CACHE.pop(arr.desc.idx, None)
                walls.append(cs.wall_s(lambda: cs.gain_table(arr, net))[0])
            print(f"{root.name} gain table build {label.split()[0]}: least "
                  f"{min(walls)!r} s, median {float(np.median(walls))!r} s",
                  flush=True)
        del res, table, arr, net
        torch.cuda.empty_cache()

    case118 = cs.power_system(str(cs.DATA / "case118.m"))
    for batch in (cs.SE_FLEET, 256):
        ac_cell(f"case118 x{batch}", case118, batch)
    grid = cs.synthetic_grid(*cs.SE_GRID)
    for batch in (cs.SE_CHUNK, 1):
        ac_cell(f"{cs.SE_GRID[0]}x{cs.SE_GRID[1]} x{batch}", grid, batch)

    system = cs.synthetic_grid(*cs.GRID)
    mon, _ = cs.dc_wattmeters(system)
    arr = cs.dc_state_estimation(mon, device="cuda").arrays
    vals, table = k8.dense_entries(arr.h_dense, arr.slack)
    dense = min(cs.event_ms(lambda: cs.dense_dc_gain(arr))[0]
                for _ in range(3))
    k8_line(f"{cs.GRID[0]}x{cs.GRID[1]} DC x1", table, vals, arr.w,
            arr.w.new_zeros(0), arr.mean[None], dense)
    for _ in range(3):
        cs.se_edits()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
