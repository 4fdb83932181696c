"""Seconds this process spent loading the port's kernel libraries, nvcc
builds included (``kernels/_build.py::load_library``, the span
``kernels.load`` of the program's ``default_timings``), all before the
window: the warm-up call loads each library the cell runs."""

from juliagrid_tpu_torch.utils.profiling import default_timings


def read(run):
    span = default_timings.spans.get("kernels.load")
    return None if span is None else span[1]
