"""End to end: the 95th percentile (linear between ranks) over every request
submitted in the window, from its submit to its answer on the host, in
ms. The requests still open when the window closes are served and
counted."""
import numpy as np


def read(ctx):
    lat = ctx.run["latencies"]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
