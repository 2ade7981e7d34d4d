"""``ed_matrix`` (``csrc/ed.cu``: ``ed_tiles`` with ``StoreDists``): the
(Q, N) float32 squared distances of Q float32 queries of length n to N
float32 rows.

A frozen copy of the count in ``PERF.md``'s kernel table (section 6):
inputs read once, the matrix written once, 2 operations a query, row and
element.
"""

NAMES = ("StoreDists",)


def cost(q: int, rows: int, n: int) -> tuple[int, int]:
    return (q * n + rows * n + q * rows) * 4, 2 * q * rows * n
