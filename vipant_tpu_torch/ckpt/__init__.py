"""Checkpoint bridges into the port (:mod:`.from_jax`)."""
