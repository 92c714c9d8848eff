"""The share of a step's or a request's time with no kernel, copy or fill on the
card, in %: the traced units' device busy time over the untraced window's time
per unit."""

from perfbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
