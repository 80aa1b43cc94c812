"""Share of the traced window in which no operation ran on the device: one
less the union of device activity over the window."""


def read(ctx):
    s = ctx.summary
    if s is None or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
