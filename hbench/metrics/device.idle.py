"""Device: share of the traced stretch in which no operation ran on the
device (1 - busy / wall; busy is the union of the profiler's device
intervals), in %. Moves ``qps``: an idle device waits on the host."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
