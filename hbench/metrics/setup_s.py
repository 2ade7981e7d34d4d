"""End to end: process start to the first timed request (imports, the
collection and queries made on the card, the build, one warm-up wave of
each k, and in a checkout's first run the kernels' compilation), in s."""


def read(ctx):
    return ctx.run["setup_s"]
