#!/usr/bin/env python3
"""K2 of one checkout timed at the fleets' shapes, for a before/after pair.

Run on a machine with one card, once for each checkout:

    python3 scripts/k2_pair.py --root DIR [--reps 20]

It imports the package and ``chip_smoke.py`` of the checkout under DIR
(so that an older tree, unpacked with ``git archive <sha> | tar -x -C
build/parent``, is measured by its own kernel), builds that tree's K2 and
times both modes, with CUDA events, on the inputs its ``chip_smoke.py``
makes from seeded generators: the NR Jacobians (LU) and the SE gains
(Cholesky) of case14, case30 and case118 at 1,024 scenarios and of case14
at 4, and the random order-236 inputs of ``k2_random``. Each line gives
K2's ms beside the library route's (``lu_factor_ex`` + ``lu_solve``,
``cholesky_ex`` + ``cholesky_solve``) in the same process, and a SHA-256
of K2's x, so that two trees can be compared for the same bits. Run the
trees in turns (parent, new, new, parent) in one call: times of one card
move between calls. About 30 s a tree.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np


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
    from juliagrid_tpu_torch.kernels import fleet_solve as k2

    cs.check(Path(k2.__file__).resolve().is_relative_to(root),
             f"imported {k2.__file__}, not the tree under {root}")
    cs.check(torch.cuda.is_available(), "no card")
    _build.load_library("fleet_solve")
    for chol in (False, True):
        make = cs.k2_se_inputs if chol else cs.k2_nr_inputs
        solve, plain = cs.k2_pair(chol)
        rng = np.random.default_rng(cs.SEED)
        cells = [(f"{case} x{batch}", make(case, batch, rng))
                 for case, batch in (("case14test", 1024),
                                     ("case30test", 1024),
                                     ("case118", 1024), ("case14test", 4))]
        cells.append(("random 236 x1024",
                      cs.k2_random(236, 1024, chol, cs.K2_CAP_SEED)))
        for label, (a, b) in cells:
            x = solve(a, b)[0]
            torch.cuda.synchronize()
            digest = hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
            ms = cs.cuda_ms(lambda: solve(a, b), args.reps)
            lib_ms = cs.cuda_ms(lambda: plain(a, b), args.reps)
            print(f"{root.name} K2 {'Cholesky' if chol else 'LU'} {label}: "
                  f"{ms!r} ms, library route {lib_ms!r} ms; x sha256 "
                  f"{digest[:16]}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
