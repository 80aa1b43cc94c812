"""Share of the HBM roofline over the traced window's sweep calls: the least
bytes of the problem (roofline.py: the field read once, the result written
once, the graph's links read once) over the card's published bandwidth,
divided by the device time of the calls (frozen _device_ms arithmetic)."""

from benchmark import roofline
from benchmark.devtrace import kind_ms, kinds


def read(ctx):
    peak = roofline.hbm_bytes_per_s(ctx.device_name)
    s = ctx.summary
    ks = kinds(s, ctx.op + ".")
    if peak is None or not ks:
        return None
    least_s = dev_s = 0.0
    for k in ks:
        ms = kind_ms(s, k)
        if ms is None or k not in ctx.bytes:
            return None
        least_s += ctx.bytes[k] / peak * s["calls"][k]
        dev_s += ms / 1e3 * s["calls"][k]
    return 100.0 * least_s / dev_s
