"""The halo runtime on every card of the machine: one rank against 2 and 4.

Run from the repository root on a machine with two or more GPUs:
    python3 tools/halo_cards.py [--json PATH]

Builds the 6000x6000 grid of ``chip_smoke.py`` (its seeded DEM with a sea,
the host priority flood, the D8 raster), runs the ``tiled_*`` functions of
its halo phase on one card (a mesh of this process alone), then
``chip_smoke.multi_card_path``: world sizes 2 and 4, as the cards allow,
one spawned rank a card over NCCL, each holding the sharded tile-plan
sweeps against the unsharded ones and the halo functions against the
one-rank results (integers, unit sums, HAND and the fill bitwise; float32
results within the stated rules). Prints each function's host-clock
seconds (synchronised) on one rank and on every rank of each world, with
the strong-scaling efficiency t1 / (k t_k) of the slowest rank, beside the
card's name and power limit. Exits non-zero with fewer than two cards or
when a check fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(json_path=None):
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print("halo_cards: needs two or more CUDA devices", file=sys.stderr)
        return 2
    import pyflwdir_torch
    from pyflwdir_torch import kernels, parallel, runtime

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    print(f"cards: {smi}")
    kernels.load()
    runtime._lib()
    H, W = cs.TILE_SHAPE
    t0 = time.perf_counter()
    z = cs._demo_dem(cs.TILE_SHAPE, cs.SEED)
    sea = np.add.outer(np.linspace(0, 1, H) ** 2, np.linspace(0, 1, W) ** 2) > 1.6
    z[sea] = -9999.0
    elev, d8 = pyflwdir_torch.fill_depressions(z, nodata=-9999.0)
    d8[sea] = 247
    fl = pyflwdir_torch.from_array(d8, transform=cs.TILE_LATLON, latlon=True)
    upa = fl.upstream_area()
    print(f"setup {time.perf_counter() - t0:.1f} s")

    torch.cuda.set_device(0)
    mesh = parallel.make_mesh()  # this process alone, card 0
    wts = np.random.RandomState(cs.HALO_SEED).rand(H, W).astype(np.float32)
    drain = upa > cs.DRAIN_CELLS
    calls = cs._halo_calls(d8, z, elev, drain, wts, fl.idxs_pit, fl.transform, mesh)
    ref, one = {}, {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref[name] = fn()
        torch.cuda.synchronize()
        one[name] = time.perf_counter() - t0
    print("one rank: " + ", ".join(f"{k} {v:.3f} s" for k, v in one.items()))
    halo = dict(ref=ref, z=z, elev=elev, drain=drain, idxs_pit=fl.idxs_pit,
                acc_rtol=cs._halo_rules(int(fl.mask.sum()))[0])
    del fl
    torch.cuda.empty_cache()
    cards = cs.multi_card_path(d8, n_cards, halo=halo)
    out = {"cards": smi, "one_rank_s": one, "worlds": {}}
    for world, ranks in cards.items():
        eff = {k: one[k] / (world * max(r["halo"][k]["s"] for r in ranks)) for k in one}
        out["worlds"][world] = dict(ranks=ranks, efficiency=eff)
        print(f"{world} ranks ({smi[0]}): strong-scaling efficiency t1 / (k t_k): "
              + ", ".join(f"{k} {v:.3f}" for k, v in eff.items()))
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"ok": True, "cards": n_cards}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the measurements to this file")
    sys.exit(main(ap.parse_args().json))
