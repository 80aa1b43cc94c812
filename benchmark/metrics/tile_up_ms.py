"""Device ms of one upward tile-plan sweep (TilePlan.accumulate: T1, the
coarse level, T2, with the call's casts and range reads), by the frozen
_device_ms arithmetic over the traced window's calls."""

from benchmark.devtrace import sweep_ms


def read(ctx):
    return sweep_ms(ctx, "up", "raster")
