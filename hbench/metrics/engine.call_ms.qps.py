"""Query engine: ``engine.call_ms`` (the mean host time of one plan call
over the window, in ms) for the cells that report ``qps`` and no latency
end to end. A wave call is nearly all of a wave, so ``qps`` is about the
slots over it."""
from hbench import spec


def read(ctx):
    return spec.metric_reader("engine.call_ms", ctx.root).read(ctx)
