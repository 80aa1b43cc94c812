"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set
from: for each seed, the numbers compared on one step of the program, and
on the control put in its place (the reference one precision lower: float32
sums of the float fields; for ``from_dem``, the DEM rounded to bfloat16).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--json chiprun_out/calib.json]

Runs on the card at the cell's own size, every seed in one process (the
set-up is long); the step is the timed path's, at the cell's load. A run of
the benchmark never runs this.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(bench, cell, seed, device, control=False, overrides=None):
    """The numbers compared on one step of the program for ``seed``, and with
    ``control`` on the control in its place: ``{"seed", "program",
    "judge_s"[, "control"]}``."""
    import torch

    from benchmark import cells, manifest
    from benchmark.devtrace import Tracer

    wl = manifest.workload(bench, cell)
    cfg = {**manifest.config(bench, wl["config"]), **(overrides or {})}
    traffic = manifest.traffic(wl["traffic"])
    run = cells.driver(traffic["op"])(cfg, traffic, seed, device, Tracer(False))
    run.setup()
    kept = run.step()
    cells._sync(device)
    t = time.perf_counter()
    row = {"seed": seed, "program": run.judge(kept)}
    del kept
    row["judge_s"] = time.perf_counter() - t
    if control:
        row["control"] = run.judge(run.control())
    run.release()
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import manifest

    bench = manifest.load()
    device = torch.device("cuda", 0)
    ctrl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        row = readings(bench, args.workload, seed, device, seed in ctrl_seeds)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
