"""Scenarios that converged to the solver's tolerance, in all the window's
calls, over all the window's time (a scenario that did not converge was
attempted and failed)."""


def read(run):
    return sum(c.converged for c in run.calls) / run.window_s
