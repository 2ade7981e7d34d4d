"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): the denominators of every roofline share. A card
set below 700 W reaches less; the run's ``device`` line names the card,
and ``PERF.md`` its power limit."""

HBM_BYTES_PER_S = 3.35e12     # HBM3
FP32_FLOPS = 67e12            # float32 outside the tensor cores


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time a launch could take: its bytes at the memory rate or
    its operations at the float32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)
