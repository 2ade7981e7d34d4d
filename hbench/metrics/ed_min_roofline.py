"""Kernels: ``ed_min``'s share of its roofline over the traced stretch, in
%: launches x the bound time of one launch (``roofline/ed_min.py``: the
wave's slot count of queries against every row) over the profiler's device
time under the kernel's names. Moves ``qps``.

The dense scan (``kernel_scan_knn``) launches ``ed_min`` once a k=1 call
and ``ed_matrix`` once a block of ``scan_block`` rows a k>1 call; where the
stretch's launches do not add up to its calls so, nothing is read."""


def read(ctx):
    calls = ctx.scan_calls()
    if ctx.trace is None or calls is None or not calls[0]:
        return None
    roof = ctx.roofline("ed_min")
    measured = ctx.kernel_seconds(roof.NAMES)
    if measured <= 0:
        return None
    nbytes, ops = roof.cost(q=ctx.shape["slots"], rows=ctx.shape["rows"], n=ctx.shape["n"])
    return 100.0 * calls[0] * ctx.bound_seconds(nbytes, ops) / measured
