"""``ed_min`` (``csrc/ed.cu``: ``ed_min_init``, then ``ed_min_resident``
or ``ed_tiles`` with ``FoldMin``, then ``ed_min_finish``): the 1-NN scan of
Q float32 queries of length n over N float32 rows, writing each query's
minimum (float32) and its row (int32).

A frozen copy of the count in ``PERF.md``'s kernel table (section 6):
inputs read once, outputs written once, 2 operations (a difference and a
fused multiply-add) a query, row and element.
"""

NAMES = ("ed_min_", "FoldMin")


def cost(q: int, rows: int, n: int) -> tuple[int, int]:
    return (q * n + rows * n) * 4 + q * 8, 2 * q * rows * n
