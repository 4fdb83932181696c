"""The power flow fleet: one ``batched_nr_solve`` a call.

A mix's keys (``traffic/<mix>.json``, besides ``entry``, ``scenarios``,
``tol``, ``max_iter`` and ``check_calls``):

- ``load_sigma``: each scenario's bus i has its net scheduled injections P
  and Q (supply less demand) multiplied by one factor
  1 + load_sigma * N(0, 1);
- ``start``: ``"setpoints"`` (the case's voltages, generator set points at
  PV and slack buses) or ``"case"`` (the stored voltages).
"""

from __future__ import annotations

import juliagrid_tpu_torch as jgt
import numpy as np
import torch
from juliagrid_tpu_torch.parallel import batched_nr_solve

from portbench.check import REFERENCE_BYTES
from portbench.generator import start_state
from portbench.reference import grid as ref

#: lockstep solves a call makes beyond its largest count
EXTRA_SOLVES = 0


def prepare(case, config, device) -> dict:
    """The reference's quantities the mix draws around: none beyond the
    case."""
    return {}


def base(params, case, prep, device) -> dict:
    vm0, va0 = start_state(params, case, device)
    return dict(vm0=vm0, va0=va0,
                p=torch.as_tensor(case.p_sched, device=device)[None],
                q=torch.as_tensor(case.q_sched, device=device)[None])


def draw(params, base, gen) -> dict:
    """One call's inputs from the generator ``gen``."""
    z = torch.randn(base["vm0"].shape, generator=gen, dtype=torch.float64,
                    device=base["vm0"].device)
    factor = 1.0 + params["load_sigma"] * z
    return dict(vm0=base["vm0"], va0=base["va0"], p=base["p"] * factor,
                q=base["q"] * factor)


class Program:
    def __init__(self, arrays, tol, max_iter):
        self.arrays, self.tol, self.max_iter = arrays, tol, max_iter

    def solve(self, inputs):
        """``(vm, va, iterations, converged)`` of one call."""
        return batched_nr_solve(self.arrays, inputs["vm0"], inputs["va0"],
                                inputs["p"], inputs["q"], tol=self.tol,
                                max_iter=self.max_iter)


def build(case_path, params, device, prep) -> Program:
    """The port's analysis of the case at ``case_path``."""
    system = jgt.power_system(str(case_path))
    analysis = jgt.newton_raphson(system, device=device)
    return Program(analysis.arrays, params["tol"], params["max_iter"])


def chunk(case, prep) -> int:
    """Scenarios the reference holds at once: its dense complex n x n
    blocks (dS/dVa, dS/dVm and their temporaries, ~128 n² bytes a
    scenario) within ``REFERENCE_BYTES``."""
    return max(1, REFERENCE_BYTES // (128 * case.n ** 2))


def reference_solve(grid, prep, params, inputs, chunk):
    return ref.nr_solve(grid, inputs["vm0"], inputs["va0"], inputs["p"],
                        inputs["q"], tol=params["tol"],
                        max_iter=params["max_iter"], chunk=chunk)


def shape(case, prep) -> dict:
    """Sizes the roofline counts take. The unknowns are the angles at PV
    and PQ buses and the magnitudes at PQ buses (``order``); the
    Jacobian's structural entries (``jac_entries``) are those of the Y
    bus's pattern that fall in an unknown's row and column: an entry (i, j)
    gives (a_i + q_i)(a_j + q_j) of them, a the non-slack and q the PQ
    indicator."""
    a = (case.bus_type != 3).astype(np.int64)
    q = (case.bus_type == 1).astype(np.int64)
    rows, cols = case.pattern()
    k = a + q
    return dict(n=case.n, nnz=len(rows), branches=len(case.f),
                order=int(k.sum()), jac_entries=int((k[rows] * k[cols]).sum()),
                extra_solves=EXTRA_SOLVES)
