"""Time one int32 flow accumulation of the Rhine-shape grid on one NVIDIA GPU,
for one or more checkouts of the repository, alternating in one call.

    python3 bench_torch_rhine.py DIR [DIR ...] [--rounds N] [--json PATH]

Each DIR is the root of a checkout that holds ``pyflwdir_torch``. The DIRs
run in the order given, ``--rounds`` times; to compare two commits give them
as ``A B B A``. Every run is a process of its own that imports the port from
its DIR, fills the seeded 997x682 DEM of ``chip_smoke.py`` (the Rhine
raster's shape), parses it and builds its AccelPlan, then takes the median
of CUDA-event timings, after warm-up, of

* ``accumulate``: ``FlwdirRaster._accumulate_dev`` on an int32 device
  tensor of ones, the call ``chip_smoke.py`` reports;
* ``plan``: ``AccelPlan.accumulate`` on the same tensor, the kernel
  wrappers (three since H3 became the permute-merge, four before) without
  the dispatch in front of them.

Prints the card, one JSON line per run, then each DIR's median over its
runs. Needs one CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPE = (997, 682)  # the Rhine D8 raster's shape
SEED = 7
LATLON = (1 / 120, 0.0, 5.0, 0.0, -1 / 120, 52.0)


def _time_ms(fn, reps, warmup):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_one(root, reps):
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
    rng = np.random.RandomState(SEED)
    z = rng.rand(*SHAPE) + np.add.outer(np.linspace(2, 0, SHAPE[0]),
                                        np.linspace(2, 0, SHAPE[1]))
    d8 = pyflwdir_torch.fill_depressions(z)[1]
    fl = pyflwdir_torch.from_array(d8, transform=LATLON, latlon=True)
    plan = fl._accel()
    ones = torch.ones(fl.size, dtype=torch.int32, device="cuda")
    if not torch.equal(fl._accumulate_dev(ones), plan.accumulate(ones)):
        raise AssertionError("the dispatch did not take the AccelPlan")
    return dict(root=root, accumulate_ms=_time_ms(lambda: fl._accumulate_dev(ones), reps, 20),
                plan_ms=_time_ms(lambda: plan.accumulate(ones), reps, 20))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--rounds", type=int, default=1, help="times to run the list")
    ap.add_argument("--reps", type=int, default=500, help="timed calls per run")
    ap.add_argument("--json", help="also write the runs to this file")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.dirs[0], args.reps)))
        return 0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    runs = []
    for _ in range(args.rounds):
        for d in map(os.path.abspath, args.dirs):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", "--reps", str(args.reps), d],
                capture_output=True, text=True, timeout=600, cwd=d,
            )
            if res.returncode != 0:
                print(res.stderr, file=sys.stderr)
                raise RuntimeError(f"the run on {d} failed")
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]))
    summary = {}
    for d in dict.fromkeys(os.path.abspath(d) for d in args.dirs):
        mine = [r for r in runs if r["root"] == d]
        summary[d] = {k: statistics.median(r[k] for r in mine)
                      for k in ("accumulate_ms", "plan_ms")}
        summary[d]["runs"] = len(mine)
    print(json.dumps({"card": smi, "median": summary}))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, runs=runs, median=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
