"""Runtime checks the port keeps from ``repro/analysis`` (a copy, as the
port imports nothing of the JAX package)."""
