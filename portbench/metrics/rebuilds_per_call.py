"""Device array rebuilds a power flow call makes
(``AcPowerFlow._refresh_arrays``): the program's span ``pf.rebuild`` of
``default_timings`` over the refreshes (``pf.refresh``), one a call. A
call whose edits change only the injections rebuilds the whole arrays
today: 1."""

from juliagrid_tpu_torch.utils.profiling import default_timings


def read(run):
    calls = default_timings.spans.get("pf.refresh", (0, 0.0))[0]
    rebuilds = default_timings.spans.get("pf.rebuild")
    if calls == 0 or rebuilds is None:
        return None
    return rebuilds[0] / calls
