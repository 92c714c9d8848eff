"""The window's model product FLOPs per second (profiler off) over the card's
bf16 peak, 989 TFLOP/s, in %."""

from perfbench.harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec)
