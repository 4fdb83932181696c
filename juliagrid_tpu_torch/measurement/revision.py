"""Measurement revision counters (reference MeasurementRevision,
definition/system.jl:404-406).

Two counters split the live-edit economics the way the reference's
update!-dispatch does (powermeter.jl:629-958, pmu.jl:566-915: in-place
row patches vs model rebuilds):

* ``measurement`` — structural: devices added, row kinds changed
  (polar/correlated/square flips). Analyses rebuild their row snapshots.
* ``values`` — numeric only: means, variances, statuses. Analyses patch
  the per-row value vectors in place; the device-resident index patterns
  (the expensive upload at ACTIVSg scale) stay untouched.

A structural bump implies a values bump, so a values-only signature can
never go stale across a rebuild.
"""

from dataclasses import dataclass


@dataclass
class MeasurementRevision:
    measurement: int = 0
    values: int = 0
