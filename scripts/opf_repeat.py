#!/usr/bin/env python3
"""Does each stage of the AC OPF's structured step give the same bits twice?

Run from the root of a checkout, on a machine with one card:

    python3 scripts/opf_repeat.py [--reps R]

On the 10k synthetic AC OPF (``synthetic_grid(100, 100, opf=True)``, its
BBD KKT in the automatic 19 blocks) at a random interior point
(``chip_smoke.k7_point``), it runs each stage of an interior-point step
``R`` times on the same inputs and prints whether every run gives the
first run's bits, and the largest difference: K7's assembly (COO values,
equilibration, blocks), the interior LU one getrf a block on its own
stream, one block's getrf, the batched getrf, ``bbd_solve_local``, the
whole ``AcKktBbd.solve``, the vector-Jacobian products of ``acopf_eq`` and
``acopf_ineq``, the Jacobian-vector product of ``acopf_ineq``, the
objective's gradient, ``AcKktBbd.row_maxes``, a getrf of the border's
order and the Schur products; then the card's ``nvidia-smi`` name and
power limit. A stage that is not repeatable makes one input give two
trajectories.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from juliagrid_tpu_torch.opf import acopf, kkt_bbd  # noqa: E402
from juliagrid_tpu_torch.ops import bbd, linalg  # noqa: E402
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid  # noqa: E402


def tensors(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [a for a in out if torch.is_tensor(a)]


def repeat(name, fn, reps):
    runs = [tensors(fn()) for _ in range(reps)]
    same = all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(runs[0], run))
    diff = max((float((a.double() - b.double()).abs().max())
                for run in runs[1:] for a, b in zip(runs[0], run)
                if a.numel()), default=0.0)
    print(f"{name}: the same bits in {reps} runs {same}, largest "
          f"difference {diff!r}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no card: this script checks the card")
    rng = np.random.default_rng(cs.SEED)
    system = synthetic_grid(*cs.KKT_GRID, opf=True)
    spec = cs.ac_optimal_power_flow(system, device="cuda")._spec
    kkt = kkt_bbd.AcKktBbd(spec, max(8, spec.n // 512))
    x, y, z, sigma, delta, sf, ge, gi = cs.k7_point(
        spec, spec.start(system), rng)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    x, y, z, sigma = t(x), t(y), t(z), t(sigma)
    pk = {"sf": sf, "ge": t(ge), "gi": t(gi)}
    arr = kkt._assemble(x, y, z, sigma, delta, pk)[2]
    rhs = t(rng.standard_normal(spec.n_x + spec.m_e))
    rx, re_ = rhs[:spec.n_x], rhs[spec.n_x:]
    a = spec.arrays
    border = t(rng.standard_normal((arr.a_bb.shape[-1],) * 2))
    stages = [
        ("K7 assembly", lambda: (lambda r: (r[0], r[1], r[2].a_ii, r[2].a_ib,
                                            r[2].a_bi, r[2].a_bb))(
            kkt._assemble(x, y, z, sigma, delta, pk))),
        ("interior getrf, a stream a block",
         lambda: linalg.lu_factor_blocks(arr.a_ii, check=False)),
        ("one block's getrf", lambda: torch.linalg.lu_factor_ex(
            arr.a_ii[0])[:2]),
        ("batched getrf", lambda: torch.linalg.lu_factor_ex(arr.a_ii)[:2]),
        ("bbd_solve_local", lambda: bbd.bbd_solve_local(arr, rhs,
                                                        check=False)),
        ("AcKktBbd.solve", lambda: kkt.solve(x, y, z, sigma, delta, rx, re_,
                                             pk)),
        ("acopf_eq vjp", lambda: torch.func.vjp(
            lambda v: acopf.acopf_eq(a, v), x)[1](y)[0]),
        ("acopf_ineq vjp", lambda: torch.func.vjp(
            lambda v: acopf.acopf_ineq(a, v), x)[1](z)[0]),
        ("acopf_ineq jvp", lambda: torch.func.jvp(
            lambda v: acopf.acopf_ineq(a, v), (x,), (rx,))[1]),
        ("objective gradient", lambda: torch.func.grad(
            lambda v: acopf.acopf_objective(a, v))(x)),
        ("row_maxes", lambda: kkt.row_maxes(x)),
        (f"getrf {border.shape[0]}²", lambda: torch.linalg.lu_factor_ex(
            border)[:2]),
        ("Schur products", lambda: arr.a_bi @ arr.a_ib),
    ]
    for name, fn in stages:
        repeat(name, fn, args.reps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
