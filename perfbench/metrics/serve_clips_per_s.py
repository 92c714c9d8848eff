"""Clips embedded in the window's requests, over the window's seconds."""

from perfbench.harness.readers import rate


def read(rec):
    return rate(rec, "serve")
