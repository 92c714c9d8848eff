"""The allocator's device memory peak over the window, GiB."""

from perfbench.harness.readers import peak_gib


def read(rec):
    return peak_gib(rec)
