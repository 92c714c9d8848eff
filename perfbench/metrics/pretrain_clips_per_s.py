"""Clips of every training step completed in the window, over the window's
seconds (host clock; the window ends on a synchronize)."""

from perfbench.harness.readers import rate


def read(rec):
    return rate(rec, "train")
