"""The 95th percentile (numpy's linear interpolation) of every call's
wall time in the window, from its start to its states, counts and flags
held on the host."""

import numpy as np


def read(run):
    return float(np.percentile([1e3 * (c.end - c.start) for c in run.calls],
                               95))
