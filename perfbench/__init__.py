"""The benchmark of ``vipant_tpu_torch`` on NVIDIA H100 cards.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
here is the yardstick: the traffic, the weights and inputs made from the seed,
the plain reference that decides ``correct``, the work counts and peaks, and
the readers that reduce a run's record to its metrics. It imports nothing of
the JAX package and measures only the port.
"""
