"""Seconds this process spent building the port's host-built kernel
tables (the span ``tables.build`` of the program's ``default_timings``):
K3's descriptor table and entry positions and K8's gain table in the
build, K8's band lists at the warm-up call, all before the window."""

from juliagrid_tpu_torch.utils.profiling import default_timings


def read(run):
    span = default_timings.spans.get("tables.build")
    return None if span is None else span[1]
