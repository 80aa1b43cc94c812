"""Device ms of one downward tile-plan sweep (TilePlan.accumulate_down: T3,
the coarse level down, T4, with the call's casts and range reads), by the
frozen _device_ms arithmetic over the traced window's calls."""

from benchmark.devtrace import sweep_ms


def read(ctx):
    return sweep_ms(ctx, "down", "raster")
