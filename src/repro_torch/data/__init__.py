"""Synthetic data for the port (``random_walks``, query workloads)."""
