"""Kernels: ``ed_matrix``'s share of its roofline over the traced stretch,
in %: for each k>1 call of the dense scan, one launch a block of
``scan_block`` rows (the last block ragged), each bound by
``roofline/ed_matrix.py``, over the profiler's device time under the
kernel's names. Moves ``qps``. As ``ed_min_roofline``, nothing is read
where the launches do not add up to the calls."""


def read(ctx):
    calls = ctx.scan_calls()
    if ctx.trace is None or calls is None or not calls[1]:
        return None
    roof = ctx.roofline("ed_matrix")
    measured = ctx.kernel_seconds(roof.NAMES)
    if measured <= 0:
        return None
    rows, block, q, n = ctx.shape["rows"], ctx.shape["scan_block"], ctx.shape["slots"], ctx.shape["n"]
    per_call = sum(ctx.bound_seconds(*roof.cost(q=q, rows=min(block, rows - lo), n=n))
                   for lo in range(0, rows, block))
    return 100.0 * calls[1] * per_call / measured
