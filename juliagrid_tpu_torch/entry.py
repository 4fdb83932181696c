"""Entry point: one Newton-Raphson step of the port on case14test.

The counterpart of the JAX package's ``__graft_entry__.py::entry``: a
caller gets a function and its example arguments, and one call of the
function is one step of the port's main path — K1's fill (injections,
mismatch and the masked Jacobian in one launch), an f64 LU solve and the
state update.
"""

from __future__ import annotations

from pathlib import Path

from .powerflow.ac import _nr_step, newton_raphson
from .system.load import power_system

#: the package's own copy of the MATPOWER case, so the entry point needs
#: nothing outside the package
CASE = Path(__file__).resolve().parent / "data" / "case14test.m"


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(arr, vm, va)`` is one
    Newton-Raphson step on case14test and returns the new ``(vm, va)``;
    its tensors are on ``device`` (default ``config.device``, the card)."""
    analysis = newton_raphson(power_system(str(CASE)), device=device)
    vm, va = analysis._state()

    def fn(arr, vm, va):
        return _nr_step(arr, vm, va, "LU")

    return fn, (analysis.arrays, vm, va)
