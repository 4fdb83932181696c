"""Each bus's demand, read from the case file with no code of the program
under test.

``case.Case`` keeps the scheduled injections only (supply less demand); a
mix that edits the loads needs the demand that it scales. Read under the
rules of ``case.py``: MATPOWER's MW and MVAr divided by ``baseMVA``, a
JuliaGrid snapshot's values in per unit as stored.
"""

from __future__ import annotations

import numpy as np

from .case import _raw_matpower, _raw_snapshot


def load_demand(path: str):
    """``(pd, qd)``: the active and reactive demand of every bus of the case
    file at ``path`` (``.m`` or ``.npz``), per unit, in bus order."""
    raw = _raw_matpower(path) if path.endswith(".m") else _raw_snapshot(path)
    return (np.asarray(raw["pd"], dtype=np.float64),
            np.asarray(raw["qd"], dtype=np.float64))
