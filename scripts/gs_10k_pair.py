#!/usr/bin/env python3
"""The 10k-lattice Gauss-Seidel mismatch that ``chip_smoke.py`` pins.

Run from the root of a checkout, on the CPU (about 70 s, and about 300 s
more with ``--level``):

    JAX_PLATFORMS=cpu python3 scripts/gs_10k_pair.py [--level]

It runs the JAX package's ``_gs_solve`` on ``synthetic_grid(100, 100)``
from the case's start for ``--sweeps`` sweeps (5,000; it does not converge)
and prints max|dP| and max|dQ| (``chip_smoke.GS_10K_PAIR``), then the same
from a start whose magnitudes are perturbed by 1e-15 (relative), to show
how far a rounding at the start moves the pair. With ``--level`` it also
runs the port's plain sweep level by level (the buses of a level at once,
the row sums in another order than XLA's) and prints its pair: the spread
that ``chip_smoke.GS_10K_REL_TOL`` is set against. This script imports the
JAX package, so it runs where that package does, not on the card's
machine.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import juliagrid_tpu  # noqa: E402,F401  (enables x64)
from juliagrid_tpu.powerflow import gauss_seidel as jax_gs  # noqa: E402
from juliagrid_tpu.utils.synthetic import synthetic_grid  # noqa: E402


def level_pair(sweeps: int):
    """The port's plain sweep, level by level, on the CPU."""
    import torch

    from juliagrid_tpu_torch.kernels.gs_sweep import _cdiv, _mismatch_ref
    from juliagrid_tpu_torch.powerflow.gauss_seidel import (_to_rect,
                                                            gauss_seidel)
    from juliagrid_tpu_torch.utils.synthetic import synthetic_grid as grid

    analysis = gauss_seidel(grid(100, 100), device="cpu")
    arr = analysis.arrays
    vre, vim = _to_rect(*analysis._state())
    for _ in range(sweeps):
        for order, ptr, pv in ((arr.pq_order, arr.pq_ptr, False),
                               (arr.pv_order, arr.pv_ptr, True)):
            ptr = ptr.tolist()
            for a, b in zip(ptr[:-1], ptr[1:]):
                bus = order[a:b].long()
                nb = arr.nb[bus].long()
                yr, yi = arr.yre[bus], arr.yim[bus]
                ire = torch.sum(yr * vre[nb] - yi * vim[nb], dim=1)
                iim = torch.sum(yr * vim[nb] + yi * vre[nb], dim=1)
                inj = (vre[bus] * iim - vim[bus] * ire if pv
                       else -arr.q_sched[bus])
                cr, ci = _cdiv(arr.p_sched[bus], inj, vre[bus], -vim[bus])
                dr, di = _cdiv(cr - ire, ci - iim, arr.dre[bus],
                               arr.dim[bus])
                vre[bus] += dr
                vim[bus] += di
        scale = torch.where(arr.bus_type == 2,
                            arr.vg / torch.sqrt(vre**2 + vim**2), 1.0)
        vre, vim = vre * scale, vim * scale
    return _mismatch_ref(arr, vre, vim).tolist()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweeps", type=int, default=5000)
    parser.add_argument("--level", action="store_true")
    args = parser.parse_args()
    analysis = jax_gs.gauss_seidel(synthetic_grid(100, 100))
    vm = np.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    noise = np.random.default_rng(1).standard_normal(vm.shape[0])
    for label, eps in (("start", 0.0), ("start perturbed by 1e-15", 1e-15)):
        out = jax_gs._gs_solve(analysis.arrays,
                               jnp.asarray(vm * (1.0 + eps * noise)), va,
                               1e-8, args.sweeps)
        print(f"JAX _gs_solve, {label}: {int(out[2])} sweeps, converged "
              f"{bool(out[5])}, max|dP| {float(out[3])!r}, max|dQ| "
              f"{float(out[4])!r}", flush=True)
    if args.level:
        dp, dq = level_pair(args.sweeps)
        print(f"port, level-by-level plain sweep: max|dP| {dp!r}, max|dQ| "
              f"{dq!r}")


if __name__ == "__main__":
    main()
