"""Host ms a power flow call spends bringing its device arrays up to the
system's revision (``AcPowerFlow._refresh_arrays``): the program's span
``pf.refresh`` of ``default_timings``, over its count, one a call; the
process's calls, the warm-up's with the window's."""

from juliagrid_tpu_torch.utils.profiling import default_timings


def read(run):
    count, seconds = default_timings.spans.get("pf.refresh", (0, 0.0))
    if count == 0:
        return None
    return 1e3 * seconds / count
