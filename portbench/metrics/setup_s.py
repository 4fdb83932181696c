"""Seconds from process start to the first timed call: the import, the
card's context, the host build, kernel builds on a checkout's first run,
and the warm-up call; less the reference's span before them (reading the
case and working out what the mix draws around), which is not the
program's."""


def read(run):
    return run.setup_s
