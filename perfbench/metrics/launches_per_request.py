"""Host-side kernel launch calls (CUDA runtime and driver, every thread) in
the traced requests, per request."""

from perfbench.harness.readers import per_unit


def read(rec):
    return per_unit(rec, "launches") if rec.get("kind") == "serve" else None
