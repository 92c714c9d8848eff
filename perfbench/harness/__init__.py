"""The harness: specs found by name, inputs and weights from the seed, the
profiler's window and its reduction, and the card's identity."""
