"""Device time of host-to-device copies in the traced steps or requests, ms
per step or request."""

from perfbench.harness.readers import per_unit


def read(rec):
    return per_unit(rec, "h2d_s", 1e3)
