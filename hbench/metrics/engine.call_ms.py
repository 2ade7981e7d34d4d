"""Query engine: mean host time of one plan call over the window
(``QueryEngine.telemetry().latency``: the host clock around each call,
ending in the device's ``synchronize``), in ms. Moves ``latency_p95_ms``:
a request waits about two calls in a full closed loop."""


def read(ctx):
    calls = ctx.delta("window", "calls")
    if not calls:
        return None
    return 1e3 * ctx.delta("window", "latency", "total") / calls
