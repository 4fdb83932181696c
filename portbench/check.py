"""The comparison that decides ``correct``.

After the window the calls kept for the check (drawn from the seed, with
the call that took the most iterations) get their inputs made again from
the seed and their indices, the plain reference (``reference/``) solves
them in float64, and two numbers are compared, each with its limit from
``limits/<cell>.json``:

- ``state_gap``: the largest |vm - vm_ref| or |va - va_ref| (per unit,
  radians) over the scenarios that the reference converged;
- ``count_gap_pct``: the share of scenarios (%) whose iteration count or
  converged flag differs from the reference's.

The reference's solve is the entry's (``entries/<entry>.py``).
``Control`` is the reference in float32 put in the program's place, the
precision below the configuration's float64: the comparison has to find
it not correct (``control.py``, ``tests/``).
"""

from __future__ import annotations

import torch

from .reference import grid as ref

NUMBERS = ("state_gap", "count_gap_pct")
#: the device memory the reference's solve of a block of scenarios may
#: hold; each entry's ``chunk`` sizes its blocks by it
REFERENCE_BYTES = 4 * 2 ** 30


class Control:
    """The reference in float32 in the program's place."""

    def __init__(self, entry, case, prep, traffic, device, chunk):
        self.entry, self.prep, self.traffic = entry, prep, traffic
        self.grid = ref.Grid.build(case, device, torch.float32)
        self.chunk = chunk

    def solve(self, inputs):
        vm, va, it, cv = self.entry.reference_solve(
            self.grid, self.prep, self.traffic, inputs, self.chunk)
        return vm.double(), va.double(), it, cv


def gaps(outputs, expected) -> dict:
    """The two numbers over the scenarios of ``outputs`` (host tensors:
    vm, va, iterations, converged) against the reference's: the state gap
    over the scenarios the reference converged (a state that is not
    finite there reads inf)."""
    vm, va, it, cv = (x.cpu() for x in outputs)
    rvm, rva, rit, rcv = (x.cpu() for x in expected)
    done = rcv.bool()
    state = 0.0
    if bool(done.any()):
        diff = torch.cat([(vm[done] - rvm[done]).abs().flatten(),
                          (va[done] - rva[done]).abs().flatten()])
        state = torch.nan_to_num(diff.double(), nan=float("inf")).max().item()
    differ = (it.int() != rit.int()) | (cv.bool() != rcv.bool())
    return dict(state_gap=state, count_gap=int(differ.sum()),
                scenarios=int(it.numel()))


def judge(kept, regenerate, solve_reference, limits) -> dict:
    """``kept``: ``[(index, outputs)]``. Returns each number with its limit
    and whether all are within them."""
    state, differ, total = 0.0, 0, 0
    for index, outputs in kept:
        got = gaps(outputs, solve_reference(regenerate(index)))
        state = max(state, got["state_gap"])
        differ += got["count_gap"]
        total += got["scenarios"]
    values = dict(state_gap=state,
                  count_gap_pct=100.0 * differ / max(total, 1))
    checks = {k: dict(value=values[k], limit=limits[k]["limit"])
              for k in NUMBERS}
    ok = total > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return dict(correct=ok, checks=checks, scenarios=total,
                calls=len(kept))
