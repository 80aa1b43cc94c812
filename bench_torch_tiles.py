"""Time the tile-plan kernels T1-T4 on the 6000x6000 grid of ``chip_smoke.py``
on one NVIDIA GPU, for one or more checkouts of the repository, alternating
in one call.

    python3 bench_torch_tiles.py DIR [DIR ...] [--rounds N] [--json PATH]

Each DIR is the root of a checkout that holds ``pyflwdir_torch``. The DIRs
run in the order given, ``--rounds`` times; to compare two commits give them
as ``A B B A``. This process fills the seeded 6000x6000 DEM once (with the
port of the checkout it lives in) and hands the D8 raster to every run; each
run is a process of its own that imports the port from its DIR, builds the
grid's tile plan and its down indices, and times each kernel wrapper on the
plan's own tables, whole grid, int32 and float64 data: ``reps`` calls back to
back between two CUDA events, the mean per call, after warm-up. The
wrappers: ``tile_pass_a`` (T1), ``tile_pass_c`` (T2, resuming from T1's
prefix sums), ``tile_down_a`` (T3) raw and routed, ``tile_down_fin`` (T4).

Prints the card, one JSON line per run, then each DIR's median over its
runs. Needs one CUDA device.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

SHAPE = (6000, 6000)  # one MERIT Hydro 5x5 degree tile at 3 arcsec
SEED = 7


def _mean_ms(fn, reps, warmup=5):
    """Mean time of one call, of ``reps`` calls back to back (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_one(root, d8_path, reps):
    """One run in this process, on the port of checkout ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import pyflwdir_torch
    from pyflwdir_torch import kernels

    if not os.path.abspath(pyflwdir_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {pyflwdir_torch.__file__}, not the port in {root}")
    kernels.load()
    fl = pyflwdir_torch.from_array(np.load(d8_path))
    tp = fl._tile_plan()
    tp._ensure_down()
    t, d = tp.idx_t, tp.down_idx_t
    shape, n = tp.shape, fl.size
    rng = np.random.RandomState(SEED)
    out = dict(root=root)
    for name, x in (("int32", torch.as_tensor(rng.randint(0, 3, n).astype(np.int32))),
                    ("float64", torch.as_tensor(rng.rand(n)))):
        x = x.cuda()
        exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], shape)
        entv = tp.entry_grid(tp.coarse.accumulate(exits.reshape(-1)))
        d1 = (x, t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
        z1, pk = kernels.tile_down_a(*d1, None, shape, False)
        A = tp.coarse.accumulate_down(pk.reshape(-1)).reshape(tp.NT, tp.R_pad)
        calls = {
            "tile_pass_a": lambda: kernels.tile_pass_a(x, t["rin"], t["ex_end"], shape),
            "tile_pass_c": lambda: kernels.tile_pass_c(x, c, entv, t["ent_idx"], t["near_end"],
                                                       t["far_end"], t["rout"], shape),
            "tile_down_a.raw": lambda: kernels.tile_down_a(*d1, None, shape, False),
            "tile_down_a.routed": lambda: kernels.tile_down_a(*d1, t["rout"], shape, True),
            "tile_down_fin": lambda: kernels.tile_down_fin(x, z1, A, d["tree_of"], t["rout"],
                                                           shape),
        }
        for k, fn in calls.items():
            out[f"{k}.{name}_ms"] = _mean_ms(fn, reps)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--rounds", type=int, default=1, help="times to run the list")
    ap.add_argument("--reps", type=int, default=50, help="timed calls per kernel and run")
    ap.add_argument("--json", help="also write the runs to this file")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the D8 file of one run
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.dirs[0], args.one, args.reps)))
        return 0

    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import pyflwdir_torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    rng = np.random.RandomState(SEED)
    z = rng.rand(*SHAPE) + np.add.outer(np.linspace(2, 0, SHAPE[0]), np.linspace(2, 0, SHAPE[1]))
    work = tempfile.mkdtemp(prefix="_plan_tmp", dir=here)
    runs = []
    try:
        d8_path = os.path.join(work, "d8.npy")
        np.save(d8_path, pyflwdir_torch.fill_depressions(z)[1])
        for _ in range(args.rounds):
            for d in map(os.path.abspath, args.dirs):
                res = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--one", d8_path, "--reps",
                     str(args.reps), d],
                    capture_output=True, text=True, timeout=900, cwd=d,
                )
                if res.returncode != 0:
                    print(res.stderr, file=sys.stderr)
                    raise RuntimeError(f"the run on {d} failed")
                runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
                print(json.dumps(runs[-1]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {}
    for d in dict.fromkeys(os.path.abspath(d) for d in args.dirs):
        mine = [r for r in runs if r["root"] == d]
        summary[d] = {k: statistics.median(r[k] for r in mine) for k in mine[0] if k != "root"}
        summary[d]["runs"] = len(mine)
    print(json.dumps({"card": smi, "median": summary}))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, runs=runs, median=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
