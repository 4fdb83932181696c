"""Launch calls begun inside the program's fleet calls, per call: the host
runtime's or driver's calls that put a kernel, a memset or a copy on a
stream (``program_spans.LAUNCH_STEMS``). A count of what a call costs the
host between kernels; an extra small kernel a trip shows here."""

from portbench.program_spans import is_launch, ops_per_call


def read(run):
    return ops_per_call(run.trace, is_launch)
