"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``) and
its entry (``entries/<entry>.py``) make each call's scenarios, on the
device, from the run's seed and the call's index.

Every mix has these keys; its entry's module lists the rest:

- ``entry``: the module under ``entries/`` that drives the program, draws
  a call's inputs and solves them with the reference;
- ``scenarios``: the scenarios a call carries;
- ``tol``, ``max_iter``: the solver's stopping rule;
- ``check_calls``: how many calls, drawn from the seed after the window,
  the comparison with the reference covers (with the call that took the
  most iterations).

Every seed draws the same sizes: only the values change.
"""

from __future__ import annotations

import hashlib

import torch


def call_seed(seed: int, index) -> int:
    """A 63-bit generator seed for call ``index`` of the run ``seed``."""
    digest = hashlib.blake2b(f"{seed}:{index}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") & (2 ** 63 - 1)


def start_state(params, case, device):
    """Every scenario's start ``[B, n]``: ``start`` ``"setpoints"`` (the
    case's voltages, generator set points at PV and slack buses: the power
    flow's start) or ``"case"`` (the stored voltages)."""
    vm = case.vm_start if params["start"] == "setpoints" else case.vm_case
    batch = int(params["scenarios"])

    def rows(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)[None] \
            .expand(batch, -1).contiguous()

    return rows(vm), rows(case.va_case)


class Traffic:
    def __init__(self, params: dict, entry, case, prep, device, seed: int):
        self.params = params
        self.entry = entry
        self.batch = int(params["scenarios"])
        self.seed = seed
        self.device = torch.device(device)
        self.base = entry.base(params, case, prep, self.device)

    def call(self, index) -> dict:
        """Call ``index``'s inputs (``index`` may also be a name, such as
        the warm-up's)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(call_seed(self.seed, index))
        return self.entry.draw(self.params, self.base, gen)
