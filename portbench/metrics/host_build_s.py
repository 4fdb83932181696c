"""Seconds of the host build: reading the case, the analysis's arrays, the
measurement set and its arrays, and K8's gain table (a host span of the
benchmark around the program's build)."""


def read(run):
    return run.host_build_s
