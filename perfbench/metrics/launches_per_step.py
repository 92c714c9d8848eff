"""Host-side kernel launch calls (CUDA runtime and driver, every thread) in
the traced steps, per step."""

from perfbench.harness.readers import per_unit


def read(rec):
    return per_unit(rec, "launches") if rec.get("kind") == "train" else None
