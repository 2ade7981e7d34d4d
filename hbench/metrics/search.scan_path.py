"""Search layer: share of the window's queries whose phase 4 scanned the
whole collection (``QueryEngine.telemetry().paths``: scan_eapca + scan_sax
+ forced_scan over every known path), in %. Moves ``qps``: a scan reads
every row where a pruned refinement reads a few chunks. Nothing to read
where every query took the forced scan."""


def read(ctx):
    n = {k: ctx.delta("window", "paths", k)
         for k in ("scan_eapca", "scan_sax", "pruned", "forced_scan")}
    known = sum(n.values())
    if not known or n["forced_scan"] == known:
        return None
    return 100.0 * (n["scan_eapca"] + n["scan_sax"] + n["forced_scan"]) / known
