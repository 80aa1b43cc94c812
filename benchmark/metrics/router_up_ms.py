"""Device ms of one upward 1-D router sweep (BigAccelPlan.accumulate: H1, H2,
H3, with the call's casts and range reads), by the frozen _device_ms
arithmetic over the traced window's calls."""

from benchmark.devtrace import sweep_ms


def read(ctx):
    return sweep_ms(ctx, "up", "network")
