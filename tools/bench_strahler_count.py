"""Time the child count of the tile-plan Strahler order, a level at a time,
on the 6000x6000 grid of ``chip_smoke.py`` (one NVIDIA GPU).

Run from the repository root:  python3 tools/bench_strahler_count.py

Builds the seeded 6000x6000 tile raster and its tile plan as
``chip_smoke.py`` does (host fill about 25 s), runs the order levels once to
collect each level's members, then times (median of CUDA-event timings) the
count that ``ops.order._generators`` makes against a scatter over every
cell, each checked bitwise against the other, a level at a time, in turns:
compacted, every cell, every cell, compacted."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import pyflwdir_torch  # noqa: E402
from pyflwdir_torch.ops import order  # noqa: E402


def every_cell(member, tgt):
    """The count as one scatter over every cell, the member flag its value."""
    n = member.numel()
    cnt = torch.zeros(n + 1, dtype=torch.int32, device=member.device)
    cnt.index_add_(0, tgt, member.to(torch.int32))
    return (cnt[:-1] >= 2) & member


def main():
    if not torch.cuda.is_available():
        print("bench_strahler_count: no CUDA device", file=sys.stderr)
        return 2
    H, W = cs.TILE_SHAPE
    z = cs._demo_dem(cs.TILE_SHAPE, cs.SEED)
    sea = np.add.outer(np.linspace(0, 1, H) ** 2, np.linspace(0, 1, W) ** 2) > 1.6
    z[sea] = -9999.0
    d8 = pyflwdir_torch.fill_depressions(z, nodata=-9999.0)[1]
    d8[sea] = 247
    fl = pyflwdir_torch.from_array(d8, transform=cs.TILE_LATLON, latlon=True)
    tp = fl._tile_plan()
    member, tgt = order._strahler_grids(order.d8_codes(fl._ds, fl.shape), tp, None)
    levels = []
    while True:
        gen = order._generators(member, tgt)
        if not bool(gen.any()):
            break
        levels.append(member)
        member = (tp.accumulate(gen.to(torch.int32)) >= 1) & member
    print(f"card: {torch.cuda.get_device_name(0)}; {len(levels)} levels, members "
          f"{[int(m.sum()) for m in levels]}")
    ways = {"compacted": order._generators, "every_cell": every_cell}
    times = {k: [] for k in ways}
    for m in levels:
        if not torch.equal(every_cell(m, tgt), order._generators(m, tgt)):
            raise AssertionError("the two counts differ")
        got = {k: [] for k in ways}
        for k in ("compacted", "every_cell", "every_cell", "compacted"):
            got[k].append(cs._time_ms(lambda: ways[k](m, tgt), reps=10, warmup=2))
        for k in ways:
            times[k].append(sum(got[k]) / 2)
    for k, v in times.items():
        print(f"{k}: {sum(v):.4f} ms over the levels; a level " + " ".join(f"{t:.4f}" for t in v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
