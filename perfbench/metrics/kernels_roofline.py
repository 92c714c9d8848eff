"""The least time the traced steps' or requests' required work could take on
the card (perfbench/work/counts.py), over the card's busy time in them, in %."""

from perfbench.harness.readers import roofline_pct


def read(rec):
    return roofline_pct(rec)
