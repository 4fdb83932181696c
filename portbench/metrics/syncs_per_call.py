"""Host waits on the device begun inside the program's fleet calls, per
call: stream, device and event synchronizes and synchronous copies
(``program_spans.SYNCS``). The fleets read one flag a trip, so a call
makes its trips + 1; more names a hidden readback."""

from portbench.program_spans import is_sync, ops_per_call


def read(run):
    return ops_per_call(run.trace, is_sync)
