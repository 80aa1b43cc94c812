"""Spread of a set of runs, as the bounds are set from it.

    python3 benchmark/spread.py chiprun_out/setA_merit3s-tile.up_*.out

Reads the result line (the last line) of each file and prints, per metric,
the median and the spread: the distance between the first and the third
quartile as Python's ``statistics.quantiles(values, n=4)`` gives them, over
the median.
"""

import json
import statistics
import sys


def spread(values):
    """(Q3 - Q1) / median of ``values``."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def table(paths):
    """{metric: (median, spread, n)} over the result lines of ``paths``."""
    vals = {}
    for p in paths:
        with open(p) as f:
            lines = f.read().strip().splitlines()
        if not lines:
            continue
        res = json.loads(lines[-1])
        for name, m in res["metrics"].items():
            vals.setdefault(name, []).append(m["value"])
    return {k: (statistics.median(v), spread(v) if len(v) > 1 else 0.0, len(v))
            for k, v in vals.items()}


if __name__ == "__main__":
    for k, (med, sp, n) in table(sys.argv[1:]).items():
        print(f"{k:24s} median {med!r:24s} spread {sp:.5f} (n {n})")
