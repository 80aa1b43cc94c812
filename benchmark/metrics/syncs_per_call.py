"""Host-blocking CUDA runtime calls (stream, device or event synchronise, a
blocking copy) inside the program's sweep calls of the traced window, per
call."""

from benchmark.devtrace import kinds


def read(ctx):
    s = ctx.summary
    ks = kinds(s, ctx.op + ".")
    calls = sum(s["calls"][k] for k in ks) if ks else 0
    if not calls:
        return None
    return sum(s["syncs"].get(k, 0) for k in ks) / calls
