"""The fleet loop's useful work over its attempts: scenario iterations
over lockstep iterations x scenarios a call, from the returned counts (a
call's lockstep iterations are its largest count)."""


def read(run):
    slots = sum(c.lockstep * c.scenarios for c in run.calls)
    if slots == 0:
        return None
    return 100.0 * sum(c.iterations for c in run.calls) / slots
