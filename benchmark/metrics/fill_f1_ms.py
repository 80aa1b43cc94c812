"""Device ms of kernel F1 (fill_sweep, ops/fill.py) per from_dem call in the
traced window. The sweeps a DEM takes vary with the DEM, so the launches per
call are taken as recorded, scaled up where the trace lost records."""

from benchmark.devtrace import kinds


def read(ctx):
    s = ctx.summary
    if "from_dem" not in kinds(s, "from_dem"):
        return None
    ops = s["ops"].get("from_dem", {})
    f1 = sum(us for name, (us, _) in ops.items() if "fill_sweep" in name)
    if not f1:
        return None
    scale = max(1.0, s["launches"].get("from_dem", 0) / max(1, s["recorded"]["from_dem"]))
    return f1 * scale / s["calls"]["from_dem"] / 1e3
