"""Kernels: ``lb_sax_matrix``'s share of its roofline over the traced
stretch, in %: launches x the bound time of one launch (``roofline/
lb_sax_matrix.py`` at the wave's shape, peaks from ``peaks.py``) over the
profiler's device time under the kernel's names. Moves ``qps``.

A wave call of the index (``wave_knn``) launches it once, with the wave's
slot count of PAA rows against the whole iSAX sidecar; where the traced
stretch's launches do not equal its wave calls, some launch had another
shape, and nothing is read."""


def read(ctx):
    if ctx.trace is None or ctx.shape.get("sax_words") is None:
        return None
    launches = ctx.delta("stretch", "launches", "lb_sax_matrix")
    if not launches or launches != ctx.delta("stretch", "wave_calls"):
        return None
    roof = ctx.roofline("lb_sax_matrix")
    measured = ctx.kernel_seconds(roof.NAMES)
    if measured <= 0:
        return None
    nbytes, ops = roof.cost(q=ctx.shape["slots"], n_words=ctx.shape["sax_words"],
                            m=ctx.shape["sax_segments"])
    return 100.0 * launches * ctx.bound_seconds(nbytes, ops) / measured
