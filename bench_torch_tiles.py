"""Time the tile-plan kernels T1-T4 on the 6000x6000 grid of ``chip_smoke.py``
on one NVIDIA GPU, for one or more checkouts of the repository, alternating
in one call.

    python3 bench_torch_tiles.py DIR [DIR ...] [--rounds N] [--rows 128,512]
                                 [--no-sharded] [--json PATH]

Each DIR is the root of a checkout that holds ``pyflwdir_torch``. The DIRs
run in the order given, ``--rounds`` times; to compare two commits give them
as ``A B B A``. This process fills the seeded 6000x6000 DEM once (with the
port of the checkout it lives in) and hands the D8 raster to every run; each
run is a process of its own that imports the port from its DIR, builds the
grid's tile plan and its down indices, and times each kernel wrapper on the
plan's own tables (each checkout's own device layout of them), int32 and
float64 data: ``reps`` calls back to back between two CUDA events, the mean
per call, after warm-up. The wrappers, on the whole grid: ``tile_pass_a``
(T1) and its exits-only mode (``.exits``), ``tile_pass_c`` (T2, resuming
from T1's prefix sums) and its full mode (``.full``, the prefix sums rebuilt
from x), ``tile_down_a`` (T3) raw and routed, ``tile_down_fin`` (T4); and in
their tile-range forms (``.range``: ``tile0=0`` over every tile, the results
as a tile stack, as one rank of the sharded sweeps runs them): T1, T2, T3
routed and T4 lite (``tile_down_lite``). Then, on a process group of one
rank over NCCL and the grid's sharded plan (``build_sharded_plan``, padded
to 6016x6016), the wall of one int32 call (``.wall``: the median over
single calls, each between two CUDA events, so host time counts) of
``accumulate_sharded``, ``accumulate``, ``accumulate_down_sharded`` and
``accumulate_down``, and of the NCCL ``all_gather`` of the exits, of the
entry values and of the result stack, these also before the sharded plan's
tables reach the card (``.first.wall``; ``--no-sharded`` leaves these out).

``--rows`` names the tile heights (128 the default plan; 256, 384 and 512
run T1-T4 as thread-block clusters of 2-4 CTAs). Each taller height builds
its own plan of the grid (``build_tile_plan(tile_rows=)``) and times the
same wrappers under keys prefixed ``y<rows>.``; it also reports, from the
plan's host tables, the share of each kernel gather whose source lies in the
chunk of the CTA that reads it (``y<rows>.own.<table>``: the tile's 128-row
chunk of slots or cells that CTA r of the cluster holds), the rest read from
a peer's shared memory.

Prints the card, the registers and spills ``ptxas`` gave each tile kernel of
each DIR, one JSON line per run, then each DIR's median over its runs and
whether every DIR's kernels gave the same bits (a SHA-256 of each wrapper's
outputs on both data types, ``digest``). Needs one CUDA device.
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


def _median_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single calls, each between two CUDA events."""
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


def _sharded_walls(d8, out):
    """The one-rank sharded walls and NCCL gathers into ``out``."""
    import datetime
    import socket

    import torch
    import torch.distributed as dist

    from pyflwdir_torch import parallel

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = parallel.make_mesh()
        tp, pshape = parallel.build_sharded_plan(d8, mesh)
        ex = torch.zeros((tp.NT, tp.R_pad), dtype=torch.int32, device="cuda")
        pk = torch.zeros((tp.NT, tp.E_pad), dtype=torch.int32, device="cuda")
        stack = torch.zeros((tp.NT, 128 * 128), dtype=torch.int32, device="cuda")
        gathers = {
            "all_gather_exits": lambda: mesh.all_gather(ex),
            "all_gather_entries": lambda: mesh.all_gather(pk),
            "all_gather_result": lambda: mesh.all_gather(stack),
        }
        # the gathers before the sharded plan's tables reach the card
        # (.first) and after its sweeps
        for k, fn in gathers.items():
            out[f"{k}.first.wall.int32_ms"] = _median_ms(fn)
        tp._ensure_down()
        ones = torch.ones(pshape[0] * pshape[1], dtype=torch.int32, device="cuda")
        calls = {
            "accumulate_sharded": lambda: tp.accumulate_sharded(ones, mesh),
            "accumulate": lambda: tp.accumulate(ones),
            "accumulate_down_sharded": lambda: tp.accumulate_down_sharded(ones, mesh),
            "accumulate_down": lambda: tp.accumulate_down(ones),
            **gathers,
        }
        for k, fn in calls.items():
            out[f"{k}.wall.int32_ms"] = _median_ms(fn)
    finally:
        dist.destroy_process_group()


def _digest(res):
    """SHA-256 of a wrapper's output tensors, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in res if isinstance(res, tuple) else (res,):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


_CHUNK = 128 * 128  # slots (cells) one CTA of a tile holds


def _own_shares(tp):
    """Share of each cluster gather whose source lies in the reading CTA's
    own chunk, from the plan's host tables (entries -1 left out): T1-T3 read
    the staged raster at ``rin`` (T1, T2 full, T3's next-slot u) and ``es``
    (T3), T2 its prefix sums at ``near_end`` / ``far_end`` and its outputs at
    ``rout``, T3 its sorted sums at ``g_last`` / ``g_prev``, its path sums at
    ``rout`` (routed) and ``ent_slot``, T1 its sums at ``ex_end``. A slot
    table's reader is the slot's chunk; ``ent_slot`` and ``ex_end`` entry j
    is read by CTA (j / 1024) mod G."""
    import numpy as np

    G = tp.G
    out = {}
    for name in ("rin", "es", "g_last", "g_prev", "near_end", "far_end", "rout", "ent_slot",
                 "ex_end"):
        src = tp.idx if name in tp.idx else tp.down_idx
        tab = np.asarray(src[name])
        reader = np.arange(tab.shape[1])
        reader = (reader // 1024) % G if name in ("ent_slot", "ex_end") else reader // _CHUNK
        on = tab >= 0
        hits = ((tab // _CHUNK) == reader[None, :]) & on
        out[name] = float(hits.sum() / max(int(on.sum()), 1))
    return out


def _time_kernels(tp, shape, n, reps, out, prefix):
    """Time each wrapper on the plan ``tp``'s tables, int32 and float64, into
    ``out`` under ``prefix``."""
    import numpy as np
    import torch

    from pyflwdir_torch import kernels

    t, d = tp.idx_t, tp.down_idx_t
    rng = np.random.RandomState(SEED)
    for name, x in (("int32", torch.as_tensor(rng.randint(0, 3, n).astype(np.int32))),
                    ("float64", torch.as_tensor(rng.rand(n)))):
        x = x.cuda()
        exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], shape)
        entv = tp.entry_grid(tp.coarse.accumulate(exits.reshape(-1)))
        d1 = (x, t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
        z1, pk = kernels.tile_down_a(*d1, None, shape, False)
        A = tp.coarse.accumulate_down(pk.reshape(-1)).reshape(tp.NT, tp.R_pad)
        a_args = (x, t["rin"], t["ex_end"], shape)
        c_args = (x, c, entv, t["ent_idx"], t["near_end"], t["far_end"], t["rout"], shape)
        full_args = (x, None, *c_args[2:])
        abar, _ = kernels.tile_down_a(*d1, t["rout"], shape, True, tile0=0)
        l_args = (abar, A, d["tree_of"], t["rout"], shape)
        calls = {
            "tile_pass_a": lambda: kernels.tile_pass_a(*a_args),
            "tile_pass_a.exits": lambda: kernels.tile_pass_a(*a_args, emit_c=False),
            "tile_pass_c": lambda: kernels.tile_pass_c(*c_args),
            "tile_pass_c.full": lambda: kernels.tile_pass_c(*full_args, rin=t["rin"]),
            "tile_down_a.raw": lambda: kernels.tile_down_a(*d1, None, shape, False),
            "tile_down_a.routed": lambda: kernels.tile_down_a(*d1, t["rout"], shape, True),
            "tile_down_fin": lambda: kernels.tile_down_fin(x, z1, A, d["tree_of"], t["rout"],
                                                           shape),
            "tile_pass_a.range": lambda: kernels.tile_pass_a(*a_args, tile0=0),
            "tile_pass_c.range": lambda: kernels.tile_pass_c(*c_args, tile0=0),
            "tile_down_a.range": lambda: kernels.tile_down_a(*d1, t["rout"], shape, True,
                                                             tile0=0),
            "tile_down_lite.range": lambda: kernels.tile_down_lite(*l_args, tile0=0),
        }
        for k, fn in calls.items():
            out["digest"][f"{prefix}{k}.{name}"] = _digest(fn())
            out[f"{prefix}{k}.{name}_ms"] = _mean_ms(fn, reps)


def run_one(root, d8_path, reps, rows=(128,), sharded=True):
    """One run in this process, on the port of checkout ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import pyflwdir_torch
    from pyflwdir_torch import kernels

    if not os.path.abspath(pyflwdir_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {pyflwdir_torch.__file__}, not the port in {root}")
    from pyflwdir_torch.ops.tile_plan import build_tile_plan

    kernels.load()
    libs = {Y: kernels._TILE_LIB[Y // 128] for Y in rows}
    out = dict(root=root, ptxas={f"{lib}:{k}": list(v) for lib in sorted(set(libs.values()))
                                 for k, v in kernels.ptxas_report(lib).items()}, digest={})
    d8 = np.load(d8_path)
    fl = pyflwdir_torch.from_array(d8)
    for Y in rows:
        if Y == 128:
            tp, prefix = fl._tile_plan(), ""
        else:
            tp, prefix = build_tile_plan(fl.idxs_ds, fl.shape, tile_rows=Y), f"y{Y}."
        tp._ensure_down()
        if Y != 128:
            out.update({f"{prefix}own.{k}": v for k, v in _own_shares(tp).items()})
        _time_kernels(tp, tp.shape, fl.size, reps, out, prefix)
        del tp
        torch.cuda.empty_cache()
    if sharded:
        _sharded_walls(d8, out)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--rounds", type=int, default=1, help="times to run the list")
    ap.add_argument("--reps", type=int, default=50, help="timed calls per kernel and run")
    ap.add_argument("--rows", default="128",
                    help="tile heights, comma-separated (128, 256, 384, 512)")
    ap.add_argument("--no-sharded", action="store_true",
                    help="leave out the one-rank sharded walls")
    ap.add_argument("--json", help="also write the runs to this file")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the D8 file of one run
    args = ap.parse_args()
    rows = tuple(int(r) for r in args.rows.split(","))
    if any(r not in (128, 256, 384, 512) for r in rows):
        ap.error(f"--rows: tile heights are 128, 256, 384 or 512, not {args.rows}")
    if args.one:
        print(json.dumps(run_one(args.dirs[0], args.one, args.reps, rows,
                                 sharded=not args.no_sharded)))
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
    runs, ptxas = [], {}
    try:
        d8_path = os.path.join(work, "d8.npy")
        np.save(d8_path, pyflwdir_torch.fill_depressions(z)[1])
        for _ in range(args.rounds):
            for d in map(os.path.abspath, args.dirs):
                res = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--one", d8_path, "--reps",
                     str(args.reps), "--rows", args.rows,
                     *(["--no-sharded"] if args.no_sharded else []), d],
                    capture_output=True, text=True, timeout=900, cwd=d,
                )
                if res.returncode != 0:
                    print(res.stderr, file=sys.stderr)
                    raise RuntimeError(f"the run on {d} failed")
                run = json.loads(res.stdout.strip().splitlines()[-1])
                regs = run.pop("ptxas")
                if d not in ptxas:
                    ptxas[d] = regs
                    for sym, (nreg, st, ld) in sorted(regs.items()):
                        print(f"ptxas {d}: {sym}: {nreg} registers, {st} B spill stores, "
                              f"{ld} B spill loads")
                runs.append(run)
                print(json.dumps(run))
                if args.json:  # each run as it ends: a later failure keeps it
                    _write(args.json, dict(card=smi, runs=runs, ptxas=ptxas))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {}
    digests = [r.pop("digest", None) for r in runs]
    for d in dict.fromkeys(os.path.abspath(d) for d in args.dirs):
        mine = [r for r in runs if r["root"] == d]
        summary[d] = {k: statistics.median(r[k] for r in mine) for k in mine[0] if k != "root"}
        summary[d]["runs"] = len(mine)
    same = None if None in digests else all(g == digests[0] for g in digests)
    print(f"the same bits from every run and DIR: {same}")
    print(json.dumps({"card": smi, "median": summary, "same_bits": same}))
    if args.json:
        _write(args.json, dict(card=smi, runs=runs, median=summary, ptxas=ptxas))
    return 0


def _write(path, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
