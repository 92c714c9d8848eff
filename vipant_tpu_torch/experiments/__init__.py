"""Probes kept beside the port: small experiments on the kernels."""
