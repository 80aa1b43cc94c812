"""Time kernels H0 (permute_gather), H1 (accel_in_scan), F1 (fill_sweep)
and whole upward router sweeps on one NVIDIA GPU, for one or more checkouts
of the repository, alternating in one call.

    python3 bench_torch_kernels.py DIR [DIR ...] [--rounds N] [--json PATH]

Each DIR is the root of a checkout that holds ``pyflwdir_torch``. The DIRs
run in the order given, ``--rounds`` times; to compare two commits give them
as ``A B B A``. Every run is a process of its own that imports the port from
its DIR and times, on seeded inputs:

* H0 at the Rhine path's shape (688,128 slots, float32) and at the 1-D
  path's (37,748,736 slots, int32 and float64), ``src`` the identity with
  each run of 2,048 slots shuffled (a DFS preorder is about that local):
  the call (median of CUDA-event timings of one call), the device time
  (profiler: the kernel's mean duration) and ``x[src]``'s call, the two
  calls in turns (library, kernel, kernel, library);
* F1: one down sweep of the 6000x6000 tile's fill from its seeded start
  (the ``chip_smoke.py`` DEM without its sea), CUDA events around 3 sweeps
  queued back to back, and its microseconds a row;
* H1 on the router plans' own ``src_in`` and one whole upward sweep
  (``plan.accumulate``: H1, H2 and H3 since the permute-merge, H1, H2, H0
  and H3 before it): at the Rhine path's shape (the 997x682 seeded DEM's
  ``AccelPlan``, float32) and at the 1-D path's (that 6000x6000 DEM through
  ``from_dem``, as a ``Flwdir``: a ``BigAccelPlan`` of 37,748,736 slots,
  int32 and float64). H1: the call, its device time and
  ``cumsum(x[src_in])``'s call in turns; the sweep: the call and its device
  time (every kernel and memset of a call, profiler).

Prints the card, one JSON line per run, then each DIR's median over its
runs. Needs one CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

SEED = 7
H0_SHAPES = (("rhine_float32", 688_128, "float32"), ("big_int32", 37_748_736, "int32"),
             ("big_float64", 37_748_736, "float64"))
TILE = (6000, 6000)
RHINE = (997, 682)
KEYS = ("call_ms", "device_ms", "library_ms")


def _time_ms(fn, reps, warmup=10):
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


def _kernel_device_ms(fn, name, calls=30):
    """Mean device duration of the kernels whose name holds ``name``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key and e.self_device_time_total > 0]
    if not hits:
        return None
    return sum(e.self_device_time_total for e in hits) / sum(e.count for e in hits) / 1e3


def _device_total_ms(fn, calls=30):
    """Device time of one call: every kernel and memset the profiler
    records over ``calls`` calls, over ``calls``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total / calls / 1e3 if total else None


def _router_cases(plan, x, reps):
    """H1 on ``plan``'s ``src_in`` and the plan's whole upward sweep on
    ``x``."""
    import torch

    from pyflwdir_torch import kernels

    src = plan._t["src_in"]
    xpad = torch.zeros(src.numel() + 1, dtype=x.dtype, device=x.device)
    xpad[: x.numel()] = x
    kern, lib = (lambda: kernels.accel_in_scan(x, src)), (lambda: torch.cumsum(xpad[src], 0))
    turns = [_time_ms(f, reps) for f in (lib, kern, kern, lib)]
    h1 = dict(call_ms=(turns[1] + turns[2]) / 2, library_ms=(turns[0] + turns[3]) / 2,
              device_ms=_device_total_ms(kern), turns_ms=turns)
    sweep = dict(call_ms=_time_ms(lambda: plan.accumulate(x), reps),
                 device_ms=_device_total_ms(lambda: plan.accumulate(x)))
    return h1, sweep


def run_one(root, reps):
    """One run in this process, on the port of checkout ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import pyflwdir_torch
    from pyflwdir_torch import kernels
    from pyflwdir_torch.ops import fill as tfill

    if not os.path.abspath(pyflwdir_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {pyflwdir_torch.__file__}, not the port in {root}")
    kernels.load()
    out = dict(root=root)
    rng = np.random.RandomState(SEED)
    for name, n, dtype in H0_SHAPES:
        src = np.arange(n, dtype=np.int32).reshape(-1, 2048)
        src = np.take_along_axis(src, np.argsort(rng.rand(*src.shape), axis=1), axis=1)
        src = torch.as_tensor(src.ravel(), device="cuda")
        x = torch.as_tensor(rng.randint(0, 1000, n), device="cuda").to(getattr(torch, dtype))
        kern, lib = (lambda: kernels.permute_gather(x, src)), (lambda: x[src])
        if not torch.equal(kern(), lib()):
            raise AssertionError(f"H0 at {name} differs from x[src]")
        turns = [_time_ms(f, reps) for f in (lib, kern, kern, lib)]
        out[name] = dict(call_ms=(turns[1] + turns[2]) / 2, library_ms=(turns[0] + turns[3]) / 2,
                         device_ms=_kernel_device_ms(kern, "permute_gather"), turns_ms=turns)
        del src, x
    rng = np.random.RandomState(SEED)
    z = rng.rand(*TILE) + np.add.outer(np.linspace(2, 0, TILE[0]), np.linspace(2, 0, TILE[1]))
    dem, seeds, bad = tfill.fill_setup(z, nodata=-9999.0, device="cuda")
    fixed = (seeds | bad).to(torch.uint8)
    w = torch.where(seeds, dem, float("inf"))
    kernels.fill_sweep(w, dem, fixed, True, True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        kernels.fill_sweep(w, dem, fixed, True, True)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 3
    out["fill_sweep_6000"] = dict(device_ms=ms, us_per_row=ms / TILE[0] * 1e3)
    del dem, seeds, bad, fixed, w

    rng = np.random.RandomState(SEED)
    zr = rng.rand(*RHINE) + np.add.outer(np.linspace(2, 0, RHINE[0]), np.linspace(2, 0, RHINE[1]))
    plan = pyflwdir_torch.from_array(pyflwdir_torch.fill_depressions(zr)[1])._accel()
    x = torch.as_tensor(rng.randint(0, 3, plan.n_cells).astype(np.float32), device="cuda")
    out["h1_rhine_float32"], out["sweep_rhine_float32"] = _router_cases(plan, x, reps)
    fr = pyflwdir_torch.from_dem(z)
    plan = pyflwdir_torch.Flwdir(fr.idxs_ds, idxs_pit=fr.idxs_pit)._accel()
    if type(plan).__name__ != "BigAccelPlan" or plan.n_pad != 37_748_736:
        raise AssertionError(f"the 1-D plan is a {type(plan).__name__} of {plan.n_pad} slots")
    for dtype in ("int32", "float64"):
        x = (torch.as_tensor(rng.rand(plan.n_cells), device="cuda") if dtype == "float64" else
             torch.as_tensor(rng.randint(0, 3, plan.n_cells).astype(np.int32), device="cuda"))
        out[f"h1_big_{dtype}"], out[f"sweep_big_{dtype}"] = _router_cases(plan, x, reps)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--rounds", type=int, default=1, help="times to run the list")
    ap.add_argument("--reps", type=int, default=200, help="timed calls per measurement")
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
        summary[d] = {case: {k: statistics.median(r[case][k] for r in mine)
                             for k in mine[0][case] if k in KEYS + ("us_per_row",)
                             and mine[0][case][k] is not None}
                      for case in mine[0] if case != "root"}
        summary[d]["runs"] = len(mine)
    print(json.dumps({"card": smi, "median": summary}))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, runs=runs, median=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
