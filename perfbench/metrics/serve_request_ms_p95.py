"""The 95th percentile of the latency of every request of the window, each
from the call to the NumPy answer in hand (host clock)."""

from perfbench.harness.readers import latency_percentile


def read(rec):
    return latency_percentile(rec, "serve", 95.0)
