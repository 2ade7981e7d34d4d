"""Serving layer: requests served over the slots the window's waves offered
(``KnnServeEngine.telemetry().serving``: served / (waves x batch_slots)),
in %. Moves ``qps``: a wave costs about the same full or not."""


def read(ctx):
    waves = ctx.delta("window", "serving", "waves")
    if not waves:
        return None
    slots = ctx.after("window", "serving", "batch_slots")
    return 100.0 * ctx.delta("window", "serving", "served") / (waves * slots)
