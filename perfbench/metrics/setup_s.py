"""Seconds from the start of the process to the first timed step: imports,
the kernel library (built only in a checkout's first run), weights, inputs
and the warm-up steps or requests."""


def read(rec):
    return rec["setup_s"]
