"""End to end: ``torch.cuda.max_memory_allocated()`` over set-up and window,
read before the reference runs, in GiB. Nothing to read off a card."""


def read(ctx):
    peak = ctx.run["peak_bytes"]
    return None if peak is None else peak / 2**30
