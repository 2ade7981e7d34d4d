"""Serving: the 95th percentile over every request submitted in the window,
read as ``latency_p95_ms`` reads it, in ms. A per-layer reading for the
cells whose tail swings too widely from run to run to bear a bound there:
a few waves of the dearest signature set it. In a full closed loop it
moves with ``qps`` (the mean wait is clients / ``qps``)."""
from hbench import spec


def read(ctx):
    return spec.metric_reader("latency_p95_ms", ctx.root).read(ctx)
