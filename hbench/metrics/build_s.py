"""End to end: the host clock around the backend's build from the
card-resident collection, ending in a ``synchronize``, in s."""


def read(ctx):
    return ctx.run["build_s"]
