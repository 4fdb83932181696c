"""Iterations a scenario took, from the counts the calls returned,
averaged over every scenario of the window."""


def read(run):
    return sum(c.iterations for c in run.calls) / \
        sum(c.scenarios for c in run.calls)
