"""End to end: answers handed out in the measured window over its seconds
(host clock; the window closes at the end of the first wave past
``--seconds``), in queries/s."""


def read(ctx):
    return ctx.run["answered"] / ctx.run["window_s"]
