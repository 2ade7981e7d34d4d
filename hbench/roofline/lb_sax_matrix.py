"""``lb_sax_matrix`` (``csrc/lb_sax.cu``): the LB_SAX bound of Q query PAA
rows (float32, m segments) against N uint8 iSAX words, written as a (Q, N)
float32 matrix.

A frozen copy of the count in ``PERF.md``'s kernel table (section 6): each
input byte read once (the PAA rows, the words, the two 256-entry float32
bound tables) and the output written once; 6m + 1 operations an entry.
"""

NAMES = ("lb_sax_v2",)


def cost(q: int, n_words: int, m: int, alphabet: int = 256) -> tuple[int, int]:
    nbytes = q * m * 4 + n_words * m + 2 * alphabet * 4 + q * n_words * 4
    return nbytes, q * n_words * (6 * m + 1)
