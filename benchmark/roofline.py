"""The least bytes a sweep moves, counted from the problem, and the card's
published peaks (``peaks.json``).

A sweep over ``n`` nodes reads its field once, writes its result once and
reads the graph once, each node's downstream link at the least whole bytes
that hold it: 1 byte for a D8 code, ``ceil(log2(n) / 8)`` bytes for an index
into ``n`` nodes. Nothing here reads a plan's tables, so the count stays the
same whatever implements the sweep.
"""

from __future__ import annotations

import json
import math
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def link_bytes(cfg, n):
    """Bytes of one node's downstream link: a D8 code on a raster, an index
    on a network."""
    if cfg["kind"] == "raster":
        return 1
    return max(1, math.ceil(math.log2(n) / 8))


def sweep_bytes(cfg, n, in_dtype, out_dtype):
    """Least bytes of one sweep of ``n`` nodes from ``in_dtype`` values to
    ``out_dtype`` results (torch dtypes)."""
    return n * (in_dtype.itemsize + out_dtype.itemsize + link_bytes(cfg, n))


def hbm_bytes_per_s(device_name):
    """The published HBM bandwidth of the card, or None for a card not in
    ``peaks.json``."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        peaks = json.load(f)
    card = peaks.get(device_name)
    return None if card is None else float(card["hbm_bytes_per_s"])
