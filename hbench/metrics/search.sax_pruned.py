"""Search layer: mean share of the collection that phase 3's LB_SAX bound
pruned per query over the window (``QueryEngine.telemetry().pruning``,
the mean of each result's ``sax_pr`` over the queries of a known path), in
%. Moves ``qps``: what is not pruned is refined or scanned. Nothing to
read where every query took the forced scan (a dense scan prunes
nothing)."""

KNOWN = ("scan_eapca", "scan_sax", "pruned", "forced_scan")


def _sums(snap):
    known = sum(snap["paths"][k] for k in KNOWN)
    return known, snap["pruning"]["sax_mean"] * known


def read(ctx):
    (k0, s0), (k1, s1) = (_sums(snap) for snap in ctx.spans["window"])
    forced = ctx.delta("window", "paths", "forced_scan")
    if k1 == k0 or forced == k1 - k0:
        return None
    return 100.0 * (s1 - s0) / (k1 - k0)
