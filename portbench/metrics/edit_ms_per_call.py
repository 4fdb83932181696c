"""Host ms a call spends before the program's power flow begins: from the
start of the benchmark's ``portbench.solve`` span to the start of the
first ``jgt.power_flow`` range inside it (``powerflow/driver.py``), read
from the traced window's host ranges. In the live-edit entry that is the
user's ``update_bus`` calls and ``set_initial_point``. None without a
trace or where no call holds the range."""

import numpy as np

from portbench.harness import SPANS

CALL = "jgt.power_flow"


def read(run):
    if run.trace is None:
        return None
    starts, names = run.trace.host_ops
    at = np.asarray([t for t, name in zip(starts, names) if name == CALL],
                    dtype=np.int64)
    gaps = []
    for s, e, name in run.trace.spans:
        if name != SPANS[1]:
            continue
        k = np.searchsorted(at, s, side="left")
        if k < len(at) and at[k] <= e:
            gaps.append(int(at[k]) - s)
    if not gaps:
        return None
    return float(np.mean(gaps)) / 1e6
