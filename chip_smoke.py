"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root:  python3 chip_smoke.py [--json PATH]
(``--json`` also writes the measurements to PATH).

1. Prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels (one nvcc per ``pyflwdir_torch/csrc/*.cu``, sm_90a, all started
   together) and the native host library from the sources; prints the
   registers and spills ptxas gave the H0, H1, H3, F1 and T1-T4 kernels
   (T1-T4 at each tile height),
   and the host time of one read of the current stream, as a Stream object
   and raw.
2. Rhine path: a 997x682 grid (the Rhine raster's shape) from a seeded DEM,
   under 2^21 cells, so the single-chunk AccelPlan (kernels H1-H3, float32).
   Kernel phase: each kernel against its plain PyTorch version on the
   card, at the shapes the path gives it, bitwise; timed (median of
   CUDA-event timings after warm-up) beside its plain version, one PyTorch
   library call where there is one (the two in turns: library, kernel,
   kernel, library), and its bound; device time from the profiler, or from
   CUDA events around back-to-back launches where its trace is empty. Then the path itself,
   with the launch counters zeroed before it and read after: fill ->
   from_array -> upstream_area (cells, km2), accuflux, rank and roots,
   checked against the sequential native oracle, mass conservation and a
   CPU run of the port.
3. Tile path: a 6000x6000 grid (one MERIT Hydro 5x5 degree tile at 3
   arcsec) from a seeded DEM with a sea of nodata in one corner, above 2^21
   cells, so the hierarchical TilePlan: kernels T1 and T2 per tile, and
   H1-H3 (int32 and float64) on its coarse level. Kernel phase as above at
   the path's shapes, int32 bitwise and float64 within rtol 1e-12 plus
   2 L eps total, L the additions on the longest chain of the sums it takes
   in another order (bitwise where it takes none). The plan's tables are
   int16 on the card. Then the path, twice with the counters zeroed: int32
   (upstream_area in cells) and float64 (upstream_area in km2, accuflux),
   checked against the native sequential sweep; then the accumulate call
   and upstream_area are timed. Order phase, on the same raster and plan:
   the Strahler order (FlwdirRaster.stream_order: one child count and one
   int32 TilePlan.accumulate a level, the D8 codes made on the device) with
   the counters zeroed, bitwise equal to the native sweep, T1, T2 and the
   coarse H1-H3 once a level; its wall time (first and a second uncached
   call), device time and one level's split beside the native sweep's; the
   classic order bitwise against its native sweep; accuflux of data with
   nodata (int32 bitwise against the native sweep on the graph cut at the
   nodata cells, float64 twice with the same bits and within the rule);
   fillnodata(direction="down") max and sum twice with the same bits;
   subbasins_streamorder() and subbasins_area() with their closure checks.
   On the Rhine path (2), subbasins_pfafstetter(depth=2), timed, with its
   closure checks.
4. Downward path on the same 6000x6000 grid: ``TilePlan.accumulate_down``
   through kernels T3 (pass D1, raw mode), H1 and H0 on the coarse level
   and T4 (pass D2). Kernel phase: T3 in both modes, T4 and the six coarse
   calls, int32 and float64, on the plan's own tables against their plain
   versions. Then the path, with the counters zeroed before each group and
   read after: stream_distance() and basins() (int32), stream_distance("m")
   and hand() (float64 sums), each against a sequential host sweep;
   accumulate_down of one float64 input twice (the same bits) and against
   the sweep; one int32 accumulate_down timed. Then the surface phase on
   the same raster and plan, each step timed (host clock, synchronised)
   with the launch counters zeroed before each group and read after:
   100,000 seeded cells snapped to the streams (1,000 cells of upstream
   area or more; host walks, no kernel), each end a stream cell or a pit
   and the last cell of its path(), which follows the flow and meets no
   stream cell before it; basins(idxs=ends) (one cut-graph downward sweep:
   T3, the coarse H1 and H0, T4, each then held against its plain version
   on that cut plan's tables) and add_pits(streams=...)
   on a copy of the raster, whose next upstream_area() builds a new plan
   and equals the native sweep of the new graph; path(unit="m") from 1,000
   headwaters, each to a pit, its length distnc at its head within the
   rule; moving_average and moving_median (n = 5, float32, -9999 nodata)
   without and with restrict_strord (T1, T2 and the coarse H1-H3 once a
   Strahler level), held to np.nanmedian and a float64 mean of the walk's
   windows at 100,000 cells, and on a 1024x1024 crop the card to the CPU
   run; upstream_sum int32 bitwise against np.add.at, float64 twice with
   the same bits; idxs_seq against the host's stable argsort of rank;
   basin_bounds() and basin_outlets() of basins() bitwise against numpy
   copies of the JAX formulas; a checkpoint.save_sharded / load_sharded
   round trip, upstream_area() bitwise; streams(min_sto=4). On the Rhine
   path (2), vectorize(), spread2d and region_dissolve of its basins, and
   dump / load, and river_depth(method="gvf"). Then the upscale phase on
   the same raster, each step timed and checked, the counters zeroed
   before each group and read after (T1, T2 and the coarse H1-H3 where the
   upstream area is derived, T3, the coarse H1 and H0 and T4 where the
   stream distance is): upscale(10) by IHU (a valid 600x600 raster with
   pits, each outlet pixel in its own cell, its upstream area summing to
   its valid count; upscale_error's disconnected count), DMM, EAM and EAM+;
   ihu_tiled(band_rows=64) on int64 / float64 memory maps, bitwise ihu()
   where no walk left its halo; a 1200x1200 crop upscaled on the card and
   on the CPU, bitwise, by all five; ucat_outlets(10), ucat_area in cells
   bitwise against np.add.at, the label of 100,000 seeded cells the first
   outlet below them (host walks), ucat_area in km2 and ucat_volume twice
   with the same bits and within (k - 1) eps sum|term| of numpy sums;
   subgrid_rivlen up and down, subgrid_rivslp (both, lstsq, 1,000 m; up),
   subgrid_rivavg / subgrid_rivmed held to numpy at 10,000 outlets,
   streams(idxs_out=...); slope(latlon=True) bitwise against a numpy copy
   of the JAX formula; floodplains(upa_min=1000) with b 0.3 and 0 against a
   host sweep over the rank levels (ulp rule at the threshold);
   dem_dig_d4; dem_adjust (no cell below its downstream cell);
   classify_estuaries bitwise against native downward sweeps of the rule;
   river_depth(method="manning").
5. 1-D path: the 6000x6000 graph as a ``Flwdir`` of 36 M nodes, past 2^21
   cells, so ``BigAccelPlan`` (G1 = 18, n_pad 37,748,736): H1-H3 at its
   shapes, int32 and float64, against their plain versions, and two float64
   H1 calls that must give the same bits; H0 and H1 at
   2^28 slots against theirs; then upstream_area, accumulate and accuflux
   against the tile plan's result and the native sweep, timed beside the
   tile plan.
6. Cut-graph path: hand() and fillnodata(direction="up") on the 6000x6000
   grid cut at the drains above ``BIG_DRAIN_CELLS`` cells, whose tile plan
   has a ``BigAccelPlan`` coarse level (slot mode); the same cut plan upward
   (accumulate) and downward (accumulate_down), int32 bitwise and float64
   within the stated bound of host sweeps over the cut graph, after a
   kernel phase on the cut plan's own tables: T1-T4 and every H0-H3 call of
   the slot-mode coarse level against their plain versions.
7. Routed path: a 2048x2048 grid whose tiles each drain to a pit of their
   own, so the plan has no entry cells and accumulate_down is T3 in routed
   mode alone; kernel phase at its shapes, then stream_distance against the
   host sweep.
8. Banded and saved-plan path on the same 6000x6000 grid and plan:
   TilePlan.accumulate_banded, the unfused pass A (kernel T1 in exits-only
   mode) and pass C (T2 in full mode) band by band with only one band's
   slices of the plan's indices on the card. Kernel phase: both modes on the
   plan's own tables against their plain versions, int32 bitwise and
   float64 by the rule. Then, with the counters zeroed, bands of 8 tile
   rows (6 bands) on unit weights and on a seeded int32 raster through
   ``out_cb``, bitwise equal to ``accumulate`` and the native sweep, and a
   float64 raster by the rule; the banded call timed beside ``accumulate``
   plus one copy of its result to the host, and the one-band sweep's kernels
   beside the fused ones on the device. Then ``save_plans`` and
   ``load_plans`` into a fresh FlwdirRaster, with the build steps counted
   (none may run): the plan's upward and downward table bytes on the card
   and on the host, the peak device memory of a banded call on the loaded
   plan against the bytes of its upward tables, and ``upstream_area()`` and
   ``stream_distance()`` bitwise equal to the built plan's; save, load and
   the first call after the load timed.
9. from_dem path, after the tile path, on its 6000x6000 DEM: the device
   depression fill, kernel F1 (one launch per sweep, one block of 1,024
   threads running the rows in order). Kernel phase: F1 against its plain
   version, bitwise, at the path's shape (down and up sweeps from the
   seeded start and from the state after 3 rounds) and with 4-connectivity
   at the Rhine shape; its microseconds a row on the device. Then
   from_dem(engine="auto") with the counters zeroed: F1 launched twice a
   round, the filled surface bitwise equal to the tile path's host priority
   flood cast to float32, valid acyclic D8 with no uphill step, and the new
   graph's upstream_area() bitwise equal to the native sweep; the fill,
   d8_from_filled and from_dem are timed apart. A 1024x1024 crop filled on
   the card and on the CPU gives the same bits; at the Rhine shape "auto"
   takes the host fill, and a device fill capped at max_depth 0.5 holds the
   cap and drains.
10. Sharded path, after the banded one, on a process group of this one
   process over NCCL (started before the first path): the 6000x6000 grid's
   D8 through parallel.build_sharded_plan (padded to 6016x6016, NT 2209).
   Kernel phase: T4 in lite mode against fin mode on the same data; T1, T2,
   T3 routed and T4 lite on two tile ranges that start and end in the
   middle of a tile row (SHARD_RANGES), bitwise against the whole-grid
   calls' slices; the four at the path's shapes (one rank's slab: every
   tile, results as a tile stack) against their plain versions, timed.
   Then, with the counters zeroed, TilePlan.accumulate_sharded and
   accumulate_down_sharded in int32 and float64 and
   tiled_accumulate(method="plan"): bitwise equal to the plan's accumulate
   and accumulate_down, int32 bitwise equal to the native sweeps, T4 lite
   launched once a downward call; both timed against the unsharded calls,
   and the NCCL gathers apart. On the closed-tiles grid (7),
   accumulate_down_sharded is T3 routed alone. Where the machine has more
   cards, world sizes 2 and 4 as they allow, one spawned rank per card:
   rank 0 builds and saves the plan, the others load it memory-mapped, and
   every rank holds both sharded sweeps against the unsharded ones.
11. Tall-tile phase, after the sharded one, on the same grid and group:
   tile plans of 256, 384 and 512 rows (24 x 47, 16 x 47 and 12 x 47
   tiles), kernels T1-T4 as thread-block clusters of 2, 3 and 4 CTAs a
   tile. For each height: the build, the down indices and the upload
   timed by step; with the counters zeroed before each call and read
   after, int32 accumulate and accumulate_down bitwise the 128-row plan's
   and the native sweeps, float64 within the rule (L at T = 128 Y slots)
   and twice with the same bits, the cluster kernels launched and no
   128-row one; both timed. At 256 and 512 rows: a kernel phase (T1 with
   and without c, T2 fused and full, T3 raw and routed, T4 fin, and the
   tile-range forms of T1, T2, T3 routed and T4 lite on ranges that start
   and end in the middle of a tile row), and on the main path the banded
   sweep (2 tile rows a band) and the one-rank sharded sweeps, bitwise the
   unsharded ones. At 512 rows the sharded plan comes from
   build_sharded_plan(tile_rows=512); the plan is saved, loaded into a new
   FlwdirRaster (no build step may run) whose upstream_area(),
   stream_distance() and stream_order() are bitwise the 128-row results;
   and the closed tiles of the routed path (7) run T3 routed alone.
12. Halo phase, after the tall-tile one, on the same one-rank group: the
   halo runtime (parallel.tiled_*) on the 6000x6000 grid as one block.
   Kernel phase: F1 on the framed buffer (6002 rows of 6016 columns:
   the block, a fixed +inf border, rows padded to 16-byte lines), down and
   up, against its plain version. Then each function timed
   (host clock, synchronised) with the counters zeroed: tiled_accumulate
   "coarse" and "iterate" on unit weights bitwise the tile plan's
   upstream_area() cast to float32, on seeded float32 weights within
   rtol 2^-24 + 2 n eps64 (and the tile plan's own atol) of the float64
   tile plan, two calls the same bits; tiled_rank and tiled_basins
   bitwise graph.rank and basins(); tiled_stream_distance in cells bitwise
   stream_distance(), in metres within (rounds + 1) 2^-24 of the float64
   sweep of the same steps; tiled_hand within 2^-23 max|elev| of hand();
   tiled_strahler bitwise stream_order(); tiled_fill bitwise the host flood
   cast to float32, F1 launched twice a round and no plain sweep run; the
   coarse accumulation's device time. With more cards, world sizes 2 and 4
   also run the halo functions, every rank's result bitwise the one-rank
   result (float32 results within the stated rules).
13. Prints a JSON line of the kernels, the card, then
   {"ok": true, "device": ...}.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SHAPE = (997, 682)  # the Rhine D8 raster's shape
TILE_SHAPE = (6000, 6000)  # one MERIT Hydro 5x5 degree tile at 3 arcsec
SEED = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM peak rates outside the tensor cores, per element type: float32
# 67 TFLOP/s and float64 34 TFLOP/s (data sheet); 32-bit integer adds run
# at half the float32 rate, and a 64-bit add takes two of them
OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12, torch.int32: 33.5e12,
             torch.int64: 16.75e12}
LATLON = (1 / 120, 0.0, 5.0, 0.0, -1 / 120, 52.0)  # 30 arcsec, near the Rhine
TILE_LATLON = (1 / 1200, 0.0, 5.0, 0.0, -1 / 1200, 50.0)  # 3 arcsec, 5-10E 45-50N
_EPS = np.finfo(np.float64).eps

_ACCEL_SRC = "pyflwdir_torch/csrc/accel_kernels.cu"
_TILE_SRC = "pyflwdir_torch/csrc/tile_kernels.cu"
_FILL_SRC = "pyflwdir_torch/csrc/fill_kernels.cu"
# file:line of the TPU kernel, inside the JAX package
_KERNELS = {
    "permute_gather": ("H0", _ACCEL_SRC,
                       "ops/router.py:153 (_ta), ops/router.py:320 (RouterPlan.apply)"),
    "accel_in_scan": ("H1", _ACCEL_SRC,
                      "ops/accel.py:200 (_accumulate_fused k1, pallas_call :226)"),
    "accel_near_out": ("H2", _ACCEL_SRC,
                       "ops/accel.py:200 (_accumulate_fused k2, pallas_call :251, and the "
                       "far ends of k3, pallas_call :282)"),
    "accel_far_merge": ("H3", _ACCEL_SRC,
                        "ops/accel.py:200 (_accumulate_fused: k2's r_out route, pallas_call "
                        ":251, k3's r_far route, pallas_call :282, and the merge :290-291)"),
}
_COARSE = {
    "accel_in_scan": "ops/tile_plan.py:590 (_CoarseRouterSmall._route of r_in + in_sel, "
                     "pallas_call :613/:635/:650/:664) and the coarse cumsum",
    "accel_near_out": "ops/router_big.py:56 (lane_gather_tiled, pallas_call :83, "
                      "in _CoarseRouterSmall._gather_pair ops/tile_plan.py:672 and for the "
                      "far ends in _CoarseRouterSmall._far_values ops/tile_plan.py:694)",
    "accel_far_merge": "ops/tile_plan.py:590 (_CoarseRouterSmall._route of r_out and of "
                       "r_far in _far_values ops/tile_plan.py:694, pallas_call "
                       ":613/:635/:650/:664) and the tree_mask select",
}
_TILE_KERNELS = {
    "tile_pass_a": ("T1", "ops/tile_plan.py:1918 (TilePlan._pass_a_fused, pallas_call :1951)"),
    "tile_pass_c": ("T2", "ops/tile_plan.py:1973 (TilePlan._pass_c_fused, pallas_call :2013)"),
    # the unfused passes of the banded sweep
    "tile_pass_a_exits": ("T1", "ops/tile_plan.py:2021 (TilePlan._pass_a_tiles, pallas_call "
                                ":2044); :1838 (TilePlan._pass_a, pallas_call :1866)"),
    "tile_pass_c_full": ("T2", "ops/tile_plan.py:2054 (TilePlan._pass_c_tiles, pallas_call "
                               ":2080); :1876 (TilePlan._pass_c, pallas_call :1908)"),
}
# T3 by mode
_DOWN_KERNELS = {
    "tile_down_a": ("T3", {
        "raw": "ops/tile_plan.py:2750 (TilePlan._pass_down_raw, pallas_call :2780)",
        "routed": "ops/tile_plan.py:2660 (TilePlan._pass_down, pallas_call :2689)"}),
    "tile_down_fin": ("T4", "ops/tile_plan.py:2796 (TilePlan._pass_down_fin, "
                            "pallas_call :2834)"),
}
_COARSE_DOWN = {
    "accel_in_scan": "ops/tile_plan.py:590 (_CoarseRouterSmall._route of r_win + w_sel + "
                     "r_es in accumulate_down :533, pallas_call :613/:635/:650/:664) and "
                     "the coarse prefix and suffix sums",
    "permute_gather": "ops/tile_plan.py:590 (_CoarseRouterSmall._route of r_dea, r_deb, "
                      "r_win and r_aout with their selects in accumulate_down :533, "
                      "pallas_call :613/:635/:650/:664)",
}
# at BigAccelPlan's shapes (the 1-D path)
_BIG = {
    "accel_in_scan": "ops/router_big.py:178 (_fused_pass, pallas_call :183) as "
                     "RouterPlanBig._chain_fused :330 runs it for r_in, and "
                     "BigAccelPlan._cumsum ops/accel_big.py:288",
    "accel_near_out": "ops/router_big.py:56 (lane_gather_tiled, pallas_call :83) in "
                      "BigAccelPlan._gather_pair ops/accel_big.py:322 and in "
                      "BigAccelPlan._far_values ops/accel_big.py:339 (the far ends)",
    "accel_far_merge": "ops/router_big.py:178 (_fused_pass, pallas_call :183; bodies "
                       "_f_kernels :111-175) as RouterPlanBig._chain_fused :330 runs it for "
                       "r_out in BigAccelPlan.accumulate ops/accel_big.py:513 and for r_far "
                       "in BigAccelPlan._far_values ops/accel_big.py:339",
}
# the downward solve of a BigAccelPlan coarse level (the cut-graph path)
_BIG_DOWN = {
    "accel_in_scan": "ops/router_big.py:178 (_fused_pass, pallas_call :183) as "
                     "RouterPlanBig._chain_fused :330 runs it for r_win and r_es in "
                     "BigAccelPlan.accumulate_down ops/accel_big.py:463, and its prefix and "
                     "suffix sums (_cumsum :288)",
    "permute_gather": "ops/router_big.py:178 (_fused_pass, pallas_call :183) as "
                      "RouterPlanBig._chain_fused :330 runs it for r_dea, r_deb, r_win and "
                      "r_aout in BigAccelPlan.accumulate_down ops/accel_big.py:463",
}
_FILL_KERNELS = {"fill_sweep": ("F1", "ops/fill.py:205 (_sweep_strip, pallas_call :239)")}
# the kernels of one upward router sweep (IntervalKernels._sweep)
_UP = ("accel_in_scan", "accel_near_out", "accel_far_merge")
# the tile kernels in their tile-range forms, as the sharded sweeps run them
_SHARD = {
    "tile_pass_a": ("T1", "ops/tile_plan.py:2090 (TilePlan._pass_a_tiles_fused, pallas_call "
                          ":2116)"),
    "tile_pass_c": ("T2", "ops/tile_plan.py:2136 (TilePlan._pass_c_tiles_fused, pallas_call "
                          ":2171)"),
    "tile_down_a": ("T3", "ops/tile_plan.py:2842 (TilePlan._pass_down_tiles, pallas_call :2867)"),
    "tile_down_lite": ("T4", "ops/tile_plan.py:2883 (TilePlan._pass_down_lite_tiles, pallas_call "
                             ":2911); :2709 (TilePlan._pass_down_lite, pallas_call :2742)"),
}
# tile ranges of the 47 x 47 tile grid that start and end in the middle of a
# tile row (the last ends the grid)
SHARD_RANGES = ((100, 1201), (1201, 2209))
DEM_CROP = 1024  # side of the crop filled on the card and on the CPU
# calls of each wrapper in one coarse-level downward sweep
_COARSE_DOWN_CALLS = {"accel_in_scan": 2, "permute_gather": 4}
ROUTED_SHAPE = (2048, 2048)  # just above 2^21 cells; every tile closed
# hand(): cells draining more than this many are drains. The cut graph has a
# local root at every drain cell: at 100,000 cells its coarse level fits the
# single-chunk router on the 6000x6000 grid, at BIG_DRAIN_CELLS it passes
# that router's 1.87 M slots and is a BigAccelPlan
DRAIN_CELLS = 100_000
BIG_DRAIN_CELLS = 30_000
BAND_TILE_ROWS = 8  # 47 tile rows in 6 bands
# the tall-tile phase: tile heights, those with a kernel phase, its
# repetitions a timing, and the band height of its banded sweeps
TALL_ROWS = (256, 384, 512)
TALL_REPS = 6
TALL_BAND_TILE_ROWS = 2
_DT = {torch.int32: "int32", torch.float64: "float64"}


def _time_ms(fn, reps=50, warmup=5):
    """Median wall time on the device of one call, from CUDA events."""
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


def _device_ms(fn, reps=20, warm=5, traces=2, kernels_only=False):
    """Device time of one call, from ``traces`` torch.profiler traces (CUPTI)
    of ``warm + reps`` calls each: every kernel's mean duration times its
    launches per call. In a long process a trace often comes back short of
    kernel records (one call's worth early on, half of them later, at times
    every record of one kernel), so the sum of the durations over the calls
    made reads low. The mean over the records that are there does not; the
    launches per call round up from the fuller trace's records / calls,
    right while fewer than calls / launches calls are lost; and a kernel
    missing from one trace is found in the other. Prints a note where
    records are missing. None when no trace holds device time.
    ``kernels_only``: copies and memsets left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls = warm + reps
    total_us, records, most = {}, {}, {}
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if kernels_only and e.key.startswith(("Memcpy", "Memset")):
                continue
            if e.self_device_time_total > 0:
                total_us[e.key] = total_us.get(e.key, 0.0) + e.self_device_time_total
                records[e.key] = records.get(e.key, 0) + e.count
                most[e.key] = max(most.get(e.key, 0), e.count)
    if not records:
        return None
    short = [n for n in records.values() if n % (traces * calls)]
    if short:
        print(f"  note: traces short of kernel records ({short} over {traces * calls} calls); "
              "mean durations used")
    return sum(total_us[k] / records[k] * -(-most[k] // calls) for k in records) / 1e3


def _bound_ms(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _index_bytes(T, tab=None):
    """The least whole bytes of an index into a tile of ``T`` slots or
    cells, one value more where the table ``tab`` holds -1: what a bound
    counts, whatever type the card's tables have (2 bytes up to T = 65,536,
    3 at 65,536 with -1)."""
    n_values = T + int(tab is not None and bool((tab < 0).any()))
    return -(-(n_values - 1).bit_length() // 8)


def _demo_dem(shape, seed):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    return z


def _check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def _close(got, want, length, total, what):
    """Check float64 sums taken in another order: a prefix sum over
    ``length`` terms of magnitude up to ``total`` is off by at most about
    length eps total in any order, and an interval difference keeps that
    error on each side: rtol 1e-12, atol 2 length eps total. Prints the
    error beside the limit."""
    atol = 2 * length * _EPS * total
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max(initial=0.0))
    _check(np.allclose(got, want, rtol=1e-12, atol=atol),
           f"{what} within rtol 1e-12, atol 2 L eps total = {atol:.3e} (L {length}; "
           f"max |err| {err:.3e} = {err / atol:.2e} of atol)")


def _scan_len(n, dtype=torch.float64):
    """Additions on the longest chain of H1's prefix sum over ``n`` slots of
    ``dtype`` (kernels.accel_in_scan_chain): a thread's slots, the warp
    scans, the look-back window and one a hop of the window over the
    tiles."""
    from pyflwdir_torch import kernels

    return kernels.accel_in_scan_chain(n, dtype)


def _h2_bytes(n_pad, n_far, s):
    """Least bytes of H2 over ``n_pad`` slots of ``s``-byte values: c read
    once (c[k-1] and the near end c[k+d], d < 128, lie in lines read anyway),
    the near end as a 1-byte offset, a 4-byte end and its value per far
    slot, the result written."""
    return (1 + 2 * s) * n_pad + (4 + s) * n_far


def _h3_bytes(n_out, n_off, s, passthrough):
    """Least bytes of H3 over ``n_out`` outputs: a 4-byte source per output,
    its subtree sum per tree output, the input per off-tree output where it
    passes through, the result written."""
    return (4 + s) * n_out + s * (n_out - n_off) + (s * n_off if passthrough else 0)


def _far_slots(t):
    """Tree slots whose interval end lies 128 or more slots on (H2's far
    reads), from the uploaded ``end``."""
    end = t["end"]
    k = torch.arange(end.numel(), device=end.device)
    return int(((end >= 0) & (end.long() - k >= 128)).sum())


def _measure(name, kern, plain, lib, n_bytes, n_ops, dtype, sums=None, reps=50,
             plain_once=False, dev_reps=20, traces=2):
    """Hold one kernel against its plain version, then time it, its plain
    version and the library call. Bitwise, unless ``sums`` is ``(L,
    total)`` and the data float64: the kernel then sums L terms up to
    ``total`` in another order (:func:`_close`). ``plain_once``: the plain
    version's time is that of the one call compared (CUDA events);
    ``traces``: the profiler traces of :func:`_device_ms`."""
    got = kern()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    # equal values (+inf among them) differ by 0
    err = max(float(torch.where(g == w, 0.0, (g.double() - w.double()).abs()).max())
              for g, w in zip(got, want) if g.numel())
    if dtype == torch.float64 and sums is not None:
        for g, w in zip(got, want):
            _close(g.cpu().numpy(), w.cpu().numpy(), *sums, f"{name} of its plain version")
    else:
        _check(all(torch.equal(g, w) for g, w in zip(got, want)),
               f"{name} bitwise equal to its plain version")
    turns = None
    if lib is None:
        ms = _time_ms(kern, reps=reps, warmup=min(5, reps))
        lib_ms = None
    else:  # in turns: library, kernel, kernel, library
        turns = [_time_ms(f, reps=reps, warmup=min(5, reps)) for f in (lib, kern, kern, lib)]
        ms, lib_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain_ms = start.elapsed_time(end) if plain_once else _time_ms(plain, reps=reps)
    dev_ms = _device_ms(kern, reps=dev_reps, warm=min(5, dev_reps), traces=traces)
    dev_src = "profiler"
    if dev_ms is None:  # an empty trace: back-to-back launches between two events
        dev_ms, dev_src = _events_ms(kern, 20), "cuda events over 20 launches"
    bound, bound_by = _bound_ms(n_bytes, n_ops, dtype)
    print(f"  {name}: {ms:.4f} ms per call, {dev_ms} ms on the device ({dev_src}; plain "
          f"{plain_ms:.4f} ms, library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
          f"bound {bound:.5f} ms by {bound_by})")
    if turns is not None:
        print(f"    in turns (library, kernel, kernel, library): "
              f"{', '.join(f'{t:.4f}' for t in turns)} ms; the kernel's call "
              f"{'below' if ms < lib_ms else 'not below'} the library's")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib_ms, device_ms=dev_ms, device_source=dev_src, turns_ms=turns,
                bytes=n_bytes)


def _events_ms(fn, launches):
    """Device time of one call from CUDA events around ``launches`` calls
    queued back to back (after a warm-up call): right where a call's host
    work is shorter than its kernels, as for F1."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def kernel_phase(plan, dev):
    """H1-H3 (float32) against their plain versions on the Rhine path's
    shapes."""
    from pyflwdir_torch import kernels

    rng = np.random.RandomState(SEED)
    n_cells = plan.n_cells
    # integer-valued data with a total below 2^24: the kernels' exact domain
    x = torch.as_tensor(rng.randint(0, 3, n_cells).astype(np.float32), device=dev)
    t = plan._t
    c = kernels.accel_in_scan(x, t["src_in"])
    outp = kernels.accel_near_out(c, t["end"])
    xpad = torch.zeros(plan.n_pad, dtype=torch.float32, device=dev)
    xpad[:n_cells] = x

    n_off = int((t["src_res"] < 0).sum())
    n = plan.n_pad
    f32 = torch.float32
    return {
        "accel_in_scan": _measure(
            "accel_in_scan",
            lambda: kernels.accel_in_scan(x, t["src_in"]),
            lambda: kernels.accel_in_scan_plain(x, t["src_in"]),
            lambda: torch.cumsum(xpad[t["src_in"]], 0), 4 * n + 4 * n_cells + 4 * n, n, f32),
        "accel_near_out": _measure(
            "accel_near_out",
            lambda: kernels.accel_near_out(c, t["end"]),
            lambda: kernels.accel_near_out_plain(c, t["end"]),
            None, _h2_bytes(n, _far_slots(t), 4), n, f32),
        "accel_far_merge": _measure(
            "accel_far_merge",
            lambda: kernels.accel_far_merge(outp, x, t["src_res"]),
            lambda: kernels.accel_far_merge_plain(outp, x, t["src_res"]),
            None, _h3_bytes(n_cells, n_off, 4, True), 0, f32),
    }


def tile_kernel_phase(tp, dtype, dev, tag="", coarse=True):
    """T1, T2 and (where ``coarse``) the coarse level's H1-H3 in ``dtype``
    against their plain versions on the shapes of the tile plan ``tp`` (of
    any tile height), with the inputs its upward sweep gives them; ``tag``
    goes into the rows' names."""
    from pyflwdir_torch import kernels

    rng = np.random.RandomState(SEED)
    H, W = tp.shape
    n = H * W
    if dtype == torch.float64:
        x = torch.as_tensor(rng.rand(n), device=dev)
    else:
        x = torch.as_tensor(rng.randint(0, 3, n).astype(np.int32), device=dev)
    total = float(x.double().sum())
    s = x.element_size()
    t = tp.idx_t
    NT, T, E = tp.NT, t["rin"].shape[1], tp.E_pad
    ix, ir = _index_bytes(T), _index_bytes(T, t["rout"])
    n_roots, n_ent = tp._coarse_meta["m"], tp._coarse_meta["D"]
    sfx = f"{tag}.{_DT[dtype]}"
    reps = _reps(tp)
    # bounds count the least bytes each function needs, not the card
    # tables' types: a slot or cell of a tile takes _index_bytes (ix; ir
    # for rout, which holds -1), a near end 1 byte (its offset from the
    # slot, < 128, or none), and far ends and entries only where a slot
    # has one
    tile_x = kernels._tiles(x.abs(), tp.shape, T).sum(1)

    exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], tp.shape)
    rows = {"tile_pass_a" + sfx: _measure(
        "tile_pass_a" + sfx,
        lambda: kernels.tile_pass_a(x, t["rin"], t["ex_end"], tp.shape),
        lambda: kernels.tile_pass_a_plain(x, t["rin"], t["ex_end"], tp.shape),
        None,
        # x per cell and rin per slot read, c per slot written; per real
        # local root its end read and its exit written
        s * n + ix * NT * T + s * NT * T + (ix + s) * n_roots, NT * T + n_roots,
        dtype, (T, float(tile_x.max())), **reps)}

    # the coarse level on pass A's exits
    co = tp.coarse._t
    xe = exits.reshape(-1)
    n_pad, n_out = co["src_in"].numel(), co["src_res"].numel()
    src_in_np = co["src_in"].cpu().numpy()
    n_off = int((co["src_res"] < 0).sum())
    cc = kernels.accel_in_scan(xe, co["src_in"])
    outp = kernels.accel_near_out(cc, co["end"])
    xpad = torch.zeros(n_pad + 1, dtype=dtype, device=dev)
    xpad[: xe.numel()] = xe
    n_read = int((src_in_np < xe.numel()).sum())
    csfx = ".coarse" + sfx
    if coarse:
        rows["accel_in_scan" + csfx] = _measure(
            "accel_in_scan" + csfx,
            lambda: kernels.accel_in_scan(xe, co["src_in"]),
            lambda: kernels.accel_in_scan_plain(xe, co["src_in"]),
            lambda: torch.cumsum(xpad[co["src_in"]], 0),
            4 * n_pad + s * n_read + s * n_pad, n_pad, dtype,
            (2 * _scan_len(n_pad, dtype), total))
        rows["accel_near_out" + csfx] = _measure(
            "accel_near_out" + csfx,
            lambda: kernels.accel_near_out(cc, co["end"]),
            lambda: kernels.accel_near_out_plain(cc, co["end"]),
            None, _h2_bytes(n_pad, _far_slots(co), s), n_pad, dtype)
        rows["accel_far_merge" + csfx] = _measure(
            "accel_far_merge" + csfx,
            lambda: kernels.accel_far_merge(outp, None, co["src_res"]),
            lambda: kernels.accel_far_merge_plain(outp, None, co["src_res"]),
            None, _h3_bytes(n_out, n_off, s, False), 0, dtype)

    entv = tp.entry_grid(kernels.accel_far_merge(outp, None, co["src_res"]))
    n_off = int((kernels._untile(t["rout"], tp.shape) < 0).sum())
    n_tfar = int((t["far_end"] >= 0).sum())
    scale = float((tile_x + entv.abs().sum(1)).max())
    args = (x, c, entv, t["ent_idx"], t["near_end"], t["far_end"], t["rout"], tp.shape)
    rows["tile_pass_c" + sfx] = _measure(
        "tile_pass_c" + sfx,
        lambda: kernels.tile_pass_c(*args),
        lambda: kernels.tile_pass_c_plain(*args),
        None,
        # c and near_end per slot, each entry's value and slot, each far
        # slot and its end, rout per cell, x per off-tree cell read; out
        # written once
        s * NT * T + NT * T + (s + ix) * n_ent + 2 * ix * n_tfar + ir * n + s * n_off + s * n,
        2 * NT * T + n_ent + n_tfar, dtype, (E + 3, scale), **reps)
    return rows


def _reps(tp):
    """``_measure``'s repetitions for the kernels of plan ``tp``: fewer on
    the tall tiles' plans (one profiler trace), whose phase times every
    kernel at three heights."""
    if tp.G == 1:
        return dict(reps=20)
    return dict(reps=TALL_REPS, dev_reps=TALL_REPS, plain_once=True, traces=1)


def _down_data(n, dtype, dev):
    rng = np.random.RandomState(SEED + 2)
    if dtype == torch.float64:
        return torch.as_tensor(rng.rand(n), device=dev)
    return torch.as_tensor(rng.randint(0, 3, n).astype(np.int32), device=dev)


def tile_down_a_rows(tp, dtype, dev, modes, tag=""):
    """T3 in each of ``modes`` ("raw", "routed") in ``dtype`` against its
    plain version on the plan's own tables. Returns the rows and the raw
    mode's outputs (None where it was not run)."""
    from pyflwdir_torch import kernels

    H, W = tp.shape
    n = H * W
    x = _down_data(n, dtype, dev)
    s = x.element_size()
    t, d = tp.idx_t, tp.down_idx_t
    NT, T = tp.NT, t["rin"].shape[1]
    ix, ir = _index_bytes(T), _index_bytes(T, t["rout"])
    n_ent = int((d["ent_slot"] >= 0).sum())
    n_last, n_prev = int((d["g_last"] >= 0).sum()), int((d["g_prev"] >= 0).sum())
    # the kernel's prefix and suffix scans each sum a tile in another order
    sums = (2 * T, float(kernels._tiles(x.abs(), tp.shape, T).sum(1).max()))
    d1 = (x, t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
    # least bytes (tile indices of _index_bytes): x per cell, rin and es per
    # slot, the run boundaries only at the ends that have them, n_tree per
    # tile and each entry's slot read; each entry's value written
    common = (s * n + 2 * ix * NT * T + ix * (n_last + n_prev) + _index_bytes(T + 1) * NT
              + (ix + s) * n_ent)
    n_ops = 3 * NT * T + n_prev  # two scans, the next slot's value, the run differences
    rows, raw = {}, None
    for mode in modes:
        routed = mode == "routed"
        args = (*d1, t["rout"] if routed else None, tp.shape, routed)
        name = f"tile_down_a.{mode}{tag}.{_DT[dtype]}"
        # z per slot written, or rout per cell read and the raster written
        n_bytes = common + ((ir + s) * n if routed else s * NT * T)
        rows[name] = _measure(name, lambda: kernels.tile_down_a(*args),
                              lambda: kernels.tile_down_a_plain(*args), None,
                              n_bytes, n_ops, dtype, sums, **_reps(tp))
        if not routed:
            raw = kernels.tile_down_a(*args)
    return rows, x, raw


def tile_down_kernel_phase(tp, dtype, dev, tag="", modes=("raw", "routed"), coarse=True):
    """T3 (in ``modes``, raw among them), the coarse level's downward H1 and
    H0 calls (where ``coarse``) and T4 in ``dtype`` against their plain
    versions on the shapes of the tile plan ``tp``, each with the inputs the
    downward sweep gives it; ``tag`` goes into the rows' names."""
    from pyflwdir_torch import kernels

    rows, x, (z1, pk) = tile_down_a_rows(tp, dtype, dev, modes, tag)
    s = x.element_size()
    n = x.numel()
    t, d = tp.idx_t, tp.down_idx_t
    NT, T = tp.NT, t["rin"].shape[1]
    sfx = f"{tag}.{_DT[dtype]}"

    # the coarse level on T3's packed entry values
    cd = tp.coarse._down_t
    n_c = cd["es_in"].numel()
    pkf = pk.reshape(-1)[:n_c]
    xpad = torch.zeros(n_c + 1, dtype=dtype, device=dev)
    xpad[: pkf.numel()] = pkf
    cs = kernels.accel_in_scan(pkf, cd["es_in"])
    inner = (kernels.permute_gather(cs, cd["g_last"]) - kernels.permute_gather(cs, cd["g_prev"])
             - kernels.permute_gather(pkf, cd["win_next"]))
    zrev = kernels.accel_in_scan(inner, cd["rev"])
    A = kernels.permute_gather(zrev, cd["fin"]).reshape(NT, tp.R_pad)

    def scan_row(name, v, idx):
        if not coarse:
            return
        n_read = int((idx < v.numel()).sum())
        total = float(v.abs().double().sum())
        rows[name] = _measure(
            name, lambda: kernels.accel_in_scan(v, idx),
            lambda: kernels.accel_in_scan_plain(v, idx),
            lambda: torch.cumsum(xpad[idx] if v is pkf else v[idx], 0),
            4 * idx.numel() + s * n_read + s * idx.numel(), idx.numel(), dtype,
            (2 * _scan_len(n_c), total))

    def gather_row(name, v, idx):
        if not coarse:
            return
        n_read = int((idx >= 0).sum())
        rows[name] = _measure(
            name, lambda: kernels.permute_gather(v, idx),
            lambda: kernels.permute_gather_plain(v, idx), None,
            (4 + s) * idx.numel() + s * n_read, 0, dtype)

    scan_row("accel_in_scan.coarse_down_es" + sfx, pkf, cd["es_in"])
    gather_row("permute_gather.coarse_down_g_last" + sfx, cs, cd["g_last"])
    gather_row("permute_gather.coarse_down_g_prev" + sfx, cs, cd["g_prev"])
    gather_row("permute_gather.coarse_down_win_next" + sfx, pkf, cd["win_next"])
    scan_row("accel_in_scan.coarse_down_rev" + sfx, inner, cd["rev"])
    gather_row("permute_gather.coarse_down_fin" + sfx, zrev, cd["fin"])

    n_off = int((kernels._untile(t["rout"], tp.shape) < 0).sum())
    n_roots = tp._coarse_meta["m"]
    it, ir = _index_bytes(tp.R_pad, d["tree_of"]), _index_bytes(T, t["rout"])
    args = (x, z1, A, d["tree_of"], t["rout"], tp.shape)
    rows["tile_down_fin" + sfx] = _measure(
        "tile_down_fin" + sfx,
        lambda: kernels.tile_down_fin(*args),
        lambda: kernels.tile_down_fin_plain(*args),
        None,
        # z1 and its tree index (of R_pad, or -1) per slot, A per real
        # root, rout per cell and x per off-tree cell read; out written once
        (s + it) * NT * T + s * n_roots + ir * n + s * n_off + s * n,
        int(d["n_tree"].sum()), dtype, **_reps(tp))
    return rows


def banded_kernel_phase(tp, dtype, dev, tag=""):
    """T1 in exits-only mode and T2 in full mode (the banded sweep's unfused
    passes) in ``dtype`` against their plain versions on the whole grid of
    the tile plan ``tp``, with its own tables and the entries its coarse
    level gives; ``tag`` goes into the rows' names."""
    from pyflwdir_torch import kernels

    rng = np.random.RandomState(SEED)
    H, W = tp.shape
    n = H * W
    if dtype == torch.float64:
        x = torch.as_tensor(rng.rand(n), device=dev)
    else:
        x = torch.as_tensor(rng.randint(0, 3, n).astype(np.int32), device=dev)
    s = x.element_size()
    t = tp.idx_t
    NT, T, E = tp.NT, t["rin"].shape[1], tp.E_pad
    ix, ir = _index_bytes(T), _index_bytes(T, t["rout"])
    n_roots, n_ent = tp._coarse_meta["m"], tp._coarse_meta["D"]
    sfx = f"{tag}.{_DT[dtype]}"
    tile_x = kernels._tiles(x.abs(), tp.shape, T).sum(1)
    a_args = (x, t["rin"], t["ex_end"], tp.shape)
    rows = {"tile_pass_a_exits" + sfx: _measure(
        "tile_pass_a_exits" + sfx,
        lambda: kernels.tile_pass_a(*a_args, emit_c=False),
        lambda: kernels.tile_pass_a_plain(*a_args, emit_c=False),
        None,
        # x per cell and rin per slot read (tile indices of _index_bytes);
        # per real local root its end read and its exit written
        s * n + ix * NT * T + (ix + s) * n_roots, NT * T + n_roots,
        dtype, (T, float(tile_x.max())), **_reps(tp))}
    exits = kernels.tile_pass_a(*a_args, emit_c=False)
    entv = tp.entry_grid(tp.coarse.accumulate(exits.reshape(-1)))
    n_off = int((kernels._untile(t["rout"], tp.shape) < 0).sum())
    n_tfar = int((t["far_end"] >= 0).sum())
    scale = float((tile_x + entv.abs().sum(1)).max())
    args = (x, None, entv, t["ent_idx"], t["near_end"], t["far_end"], t["rout"], tp.shape)
    rows["tile_pass_c_full" + sfx] = _measure(
        "tile_pass_c_full" + sfx,
        lambda: kernels.tile_pass_c(*args, rin=t["rin"]),
        lambda: kernels.tile_pass_c_plain(*args, rin=t["rin"]),
        None,
        # x per cell (for the prefix sums and the passthrough), rin per slot,
        # near_end (1 byte) per slot, each entry's value and slot, each far
        # slot and its end, rout per cell read; out written once
        s * n + ix * NT * T + NT * T + (s + ix) * n_ent + 2 * ix * n_tfar + ir * n + s * n,
        3 * NT * T + n_ent + n_tfar, dtype, (T + E + 3, scale), **_reps(tp))
    return rows


def _unfused(tp, x):
    """The one-band sweep's device work on the plan's resident tables: T1
    exits only, the coarse level, T2 in full mode."""
    from pyflwdir_torch import kernels

    t = tp.idx_t
    exits = kernels.tile_pass_a(x, t["rin"], t["ex_end"], tp.shape, emit_c=False)
    entv = tp.entry_grid(tp.coarse.accumulate(exits.reshape(-1)))
    return kernels.tile_pass_c(x, None, entv, t["ent_idx"], t["near_end"], t["far_end"],
                               t["rout"], tp.shape, rin=t["rin"])


class _Rebuilds:
    """Counts the tile plan's build steps (phase 1, the down sort phase, the
    plan's constructor) made inside the block."""

    def __enter__(self):
        from pyflwdir_torch import runtime
        from pyflwdir_torch.ops.tile_plan import TilePlan

        self.calls = {}
        self._real = [(runtime, "tile_plan_phase1"), (runtime, "tile_down_phase"),
                      (TilePlan, "__init__")]
        self._real = [(obj, name, getattr(obj, name)) for obj, name in self._real]
        for obj, name, fn in self._real:
            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*a, **k)

            setattr(obj, name, counted)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._real:
            setattr(obj, name, fn)


def banded_path(fl, tp, upa, seq, built_s, dev):
    """The banded sweep and saved plans on the 6000x6000 grid and its plan
    ``tp`` (``upa`` its upstream area in cells, ``seq`` its cells with
    downstream ones first, ``built_s`` the seconds of its build); returns
    the kernel rows and timings."""
    import pyflwdir_torch
    from pyflwdir_torch import kernels, runtime

    print(" banded path:")
    t_path = time.perf_counter()
    rows = {}
    for dtype in (torch.int32, torch.float64):
        print(f" kernel phase, unfused passes ({_DT[dtype]}):")
        rows[dtype] = banded_kernel_phase(tp, dtype, dev)

    print(f" main path, banded ({BAND_TILE_ROWS} tile rows a band):")
    H, W = fl.shape
    n = H * W
    nb = -(-tp.grid[0] // BAND_TILE_ROWS)
    rng = np.random.RandomState(SEED + 6)
    w = rng.randint(0, 3, (H, W)).astype(np.int32)
    fdata = rng.rand(H, W)
    counts, secs, parts = {}, {}, []
    for name, fn in (
            ("ones", lambda: tp.accumulate_banded(None, BAND_TILE_ROWS)),
            ("int32", lambda: tp.accumulate_banded(
                w, BAND_TILE_ROWS, out_cb=lambda b, r0, a: parts.append((b, r0, a.copy())))),
            ("float64", lambda: tp.accumulate_banded(fdata, BAND_TILE_ROWS))):
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        counts[name] = dict(kernels.launches)
        print(f"  accumulate_banded ({name}) {secs[name]:.3f} s; launches {counts[name]}")
        if name == "ones":
            ones_b = out
        elif name == "float64":
            f_b = out
    want = {"tile_pass_a_exits": nb, "tile_pass_c_full": nb, **{k: 1 for k in _UP}}
    for name, c in counts.items():
        _check(all(c[k] == want.get(k, 0) for k in c),
               f"the banded sweep ({name}) launched T1 exits-only and T2 full once a band "
               f"({nb} bands), H1, H2 and H3 once, and no fused pass or H0")

    t0 = time.perf_counter()
    mask = fl.mask.reshape(H, W)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    mono = tp.accumulate(ones).cpu().numpy().reshape(H, W)
    _check(ones_b.dtype == np.int32 and ones_b.shape == (H, W) and np.array_equal(ones_b, mono)
           and np.array_equal(ones_b[mask], upa[mask]),
           "accumulate_banded(None) int32 bitwise equal to accumulate and to the native sweep")
    _check([p[:2] for p in parts] == [(b, b * BAND_TILE_ROWS * 128) for b in range(nb)]
           and sum(p[2].shape[0] for p in parts) == H,
           f"out_cb took the {nb} bands in order, their rows adding up to the grid's")
    got = np.concatenate([p[2] for p in parts])
    want_w = runtime.accuflux_sweep(fl.idxs_ds, seq, w.ravel().astype(np.float64))
    _check(got.dtype == np.int32
           and np.array_equal(got, tp.accumulate(torch.as_tensor(w.ravel(), device=dev))
                              .cpu().numpy().reshape(H, W))
           and np.array_equal(got[mask], want_w.reshape(H, W)[mask].astype(np.int32)),
           "accumulate_banded(int32 raster, out_cb) bitwise equal to accumulate and to the "
           "native sweep")
    length = 128 * 128 + 2 * _scan_len(tp.coarse.n_pad) + tp.E_pad
    _close(f_b, runtime.accuflux_sweep(fl.idxs_ds, seq, fdata.ravel()).reshape(H, W), length,
           float(fdata.sum()), "accumulate_banded(float64) of the native sweep")
    fd = torch.as_tensor(fdata.ravel(), device=dev)
    _check(np.array_equal(f_b.ravel(), tp.accumulate(fd).cpu().numpy()),
           "accumulate_banded(float64) bitwise equal to accumulate (the same scans)")
    _check(torch.equal(_unfused(tp, ones), tp.accumulate(ones)),
           "the one-band sweep's kernels on resident tables bitwise equal to accumulate")
    print(f"  checks {time.perf_counter() - t0:.2f} s")

    banded_ms = _host_ms(lambda: tp.accumulate_banded(None, BAND_TILE_ROWS), 3)
    one_band_ms = _host_ms(lambda: tp.accumulate_banded(None), 3)
    mono_ms = _host_ms(lambda: tp.accumulate(ones).cpu().numpy(), 5)
    unf_ms = _time_ms(lambda: _unfused(tp, ones), reps=20, warmup=3)
    unf_dev = _device_ms(lambda: _unfused(tp, ones))
    fused_ms = _time_ms(lambda: tp.accumulate(ones), reps=20, warmup=3)
    fused_dev = _device_ms(lambda: tp.accumulate(ones))
    one_band_dev = _device_ms(lambda: tp.accumulate_banded(None), reps=3, warm=1,
                              kernels_only=True)
    print(f"  accumulate_banded(None, {BAND_TILE_ROWS}) {banded_ms:.3f} ms, one band "
          f"{one_band_ms:.3f} ms (its kernels {one_band_dev} ms on the device); accumulate + "
          f"copy of its result to the host {mono_ms:.3f} ms")
    print(f"  on resident tables: unfused (T1 exits, coarse, T2 full) {unf_ms:.4f} ms a call, "
          f"{unf_dev} ms on the device; fused (T1, coarse, T2) {fused_ms:.4f} ms, {fused_dev} ms")

    print(" saved plans:")
    plan_dir = tempfile.mkdtemp(prefix="_plan_tmp", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        t0 = time.perf_counter()
        fl.save_plans(plan_dir, down=True)
        t_save = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(plan_dir)
                   for f in fs)
        dist = fl.stream_distance()
        with _Rebuilds() as rb:
            fl2 = pyflwdir_torch.FlwdirRaster(fl.idxs_ds, fl.shape, "d8", fl.idxs_pit,
                                              transform=fl.transform, latlon=fl.latlon,
                                              device=fl.device)
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            tp2 = fl2.load_plans(plan_dir)
            t_load = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            b2 = tp2.accumulate_banded(None, BAND_TILE_ROWS)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - m0
            no_upload = tp2._idx_t is None
            t0 = time.perf_counter()
            upa2 = fl2.upstream_area()
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            dist2 = fl2.stream_distance()
            t_first_down = time.perf_counter() - t0
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
    up_bytes = sum(v.nbytes for v in tp.idx.values())
    card_bytes = {k: sum(v.numel() * v.element_size() for v in t.values())
                  for k, t in (("upward", tp.idx_t), ("downward", tp.down_idx_t))}
    print(f"  the plan's tables on the card: upward {card_bytes['upward']} bytes, downward "
          f"{card_bytes['downward']} bytes (int16; on the host, int32: upward {up_bytes}, "
          f"downward {sum(v.nbytes for v in tp.down_idx.values())} bytes)")
    print(f"  save_plans {t_save:.3f} s ({disk} bytes on disk); load_plans {t_load:.3f} s; first "
          f"upstream_area() after the load {t_first:.3f} s, first stream_distance() "
          f"{t_first_down:.3f} s; the build: tile plan {built_s['tile_plan_s']:.2f} s, down "
          f"indices {built_s['down_indices_s']:.2f} s")
    print(f"  peak device memory of a banded call on the loaded plan {peak} bytes; its upward "
          f"tables {up_bytes} bytes")
    _check(not rb.calls, f"load_plans and the calls after it ran no build step ({rb.calls})")
    _check(no_upload and np.array_equal(b2, ones_b),
           "a banded call on the loaded plan uploaded no whole table and gave the same bits")
    _check(peak < up_bytes / 2,
           f"its peak device memory ({peak / 1e6:.1f} MB) under half its upward tables' "
           f"bytes ({up_bytes / 1e6:.1f} MB)")
    _check(np.array_equal(upa2, upa) and np.array_equal(dist2, dist),
           "upstream_area() and stream_distance() of the loaded plan bitwise equal to the "
           "built plan's")

    t_path = time.perf_counter() - t_path
    print(f"  banded path {t_path:.1f} s")
    path = "tile 6000x6000 banded"
    krows = _rows(rows[torch.int32], counts["int32"], path, "int32")
    krows += _rows(rows[torch.float64], counts["float64"], path, "float64")
    return krows, dict(bands=nb, banded_s=secs, banded_ms=banded_ms, one_band_ms=one_band_ms,
                       one_band_kernels_device_ms=one_band_dev,
                       accumulate_plus_copy_ms=mono_ms, unfused_ms=unf_ms,
                       unfused_device_ms=unf_dev, fused_ms=fused_ms, fused_device_ms=fused_dev,
                       save_s=t_save, plan_bytes_on_disk=disk, load_s=t_load,
                       first_upstream_area_s=t_first, first_stream_distance_s=t_first_down,
                       peak_bytes=peak, upward_table_bytes=up_bytes,
                       card_table_bytes=card_bytes, path_s=t_path,
                       **built_s)


def sharded_kernel_phase(tp, dtype, dev, tag="", ranges=SHARD_RANGES):
    """T4 in lite mode against fin mode on the same data; T1, T2, T3
    (routed) and T4 lite on the tile ranges ``ranges``, each bitwise
    against the same slice of its whole-grid call; then the four at the
    sharded path's shapes (one rank: its slab is every tile, a tile range
    from tile 0, results as a tile stack) against their plain versions,
    timed. ``tp`` is the sharded plan (or any plan: on one rank), its down
    indices built; ``tag`` goes into the rows' names."""
    from pyflwdir_torch import kernels

    H, W = shape = tp.shape
    n = H * W
    x = _down_data(n, dtype, dev)
    s = x.element_size()
    t, d = tp.idx_t, tp.down_idx_t
    NT, T, E, ntx = tp.NT, t["rin"].shape[1], tp.E_pad, tp.grid[1]
    ix, ir = _index_bytes(T), _index_bytes(T, t["rout"])
    sfx = f".shard{tag}.{_DT[dtype]}"
    up = (t["ent_idx"], t["near_end"], t["far_end"], t["rout"])
    d1 = (t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])

    exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], shape)
    entv = tp.entry_grid(tp.coarse.accumulate(exits.reshape(-1)))
    out_t = kernels._tiles(kernels.tile_pass_c(x, c, entv, *up, shape), shape, T)
    z1, pk = kernels.tile_down_a(x, *d1, None, shape, False)
    abar, _ = kernels.tile_down_a(x, *d1, t["rout"], shape, True)
    A = tp.coarse.accumulate_down(pk.reshape(-1)).reshape(NT, tp.R_pad)
    lite = kernels.tile_down_lite(abar, A, d["tree_of"], t["rout"], shape)
    fin = kernels.tile_down_fin(x, z1, A, d["tree_of"], t["rout"], shape)
    torch.cuda.synchronize()
    _check(torch.equal(lite, fin), f"T4 lite on the routed pass D1 bitwise equal to T4 fin on "
                                   f"the raw one ({_DT[dtype]}, whole grid)")
    abar_t, lite_t = kernels._tiles(abar, shape, T), kernels._tiles(lite, shape, T)
    del z1, fin, abar, lite
    for lo, hi in ranges:
        r = slice(lo, hi)
        ex_r, c_r = kernels.tile_pass_a(x, t["rin"][r], t["ex_end"][r], shape, tile0=lo)
        out_r = kernels.tile_pass_c(x, c_r, entv[r], *(v[r] for v in up), shape, tile0=lo)
        ab_r, pk_r = kernels.tile_down_a(x, *(v[r] for v in d1), t["rout"][r], shape, True,
                                         tile0=lo)
        li_r = kernels.tile_down_lite(ab_r, A[r], d["tree_of"][r], t["rout"][r], shape, tile0=lo)
        torch.cuda.synchronize()
        _check(torch.equal(ex_r, exits[r]) and torch.equal(c_r, c[r])
               and torch.equal(out_r, out_t[r]) and torch.equal(ab_r, abar_t[r])
               and torch.equal(pk_r, pk[r]) and torch.equal(li_r, lite_t[r]),
               f"T1, T2, T3 routed and T4 lite on tiles {lo}..{hi - 1} (tile row {lo // ntx} "
               f"column {lo % ntx} to row {(hi - 1) // ntx} column {(hi - 1) % ntx}) bitwise "
               f"equal to the whole-grid calls' slices ({_DT[dtype]})")
    del out_t, lite_t, ex_r, c_r, out_r, ab_r, pk_r, li_r

    # bounds: the least bytes (tile indices of _index_bytes, 1-byte near offsets),
    # as the whole-grid rows count them; the results are a tile stack
    n_roots, n_ent = tp._coarse_meta["m"], tp._coarse_meta["D"]
    tile_x = kernels._tiles(x.abs(), shape, T).sum(1)
    reps = _reps(tp)
    rows = {}
    a_args = (x, t["rin"], t["ex_end"], shape)
    rows["tile_pass_a" + sfx] = _measure(
        "tile_pass_a" + sfx, lambda: kernels.tile_pass_a(*a_args, tile0=0),
        lambda: kernels.tile_pass_a_plain(*a_args, tile0=0), None,
        s * n + ix * NT * T + s * NT * T + (ix + s) * n_roots, NT * T + n_roots, dtype,
        (T, float(tile_x.max())), **reps)
    n_off = int((t["rout"] < 0).sum())
    n_tfar = int((t["far_end"] >= 0).sum())
    scale = float((tile_x + entv.abs().sum(1)).max())
    c_args = (x, c, entv, *up, shape)
    rows["tile_pass_c" + sfx] = _measure(
        "tile_pass_c" + sfx, lambda: kernels.tile_pass_c(*c_args, tile0=0),
        lambda: kernels.tile_pass_c_plain(*c_args, tile0=0), None,
        s * NT * T + NT * T + (s + ix) * n_ent + 2 * ix * n_tfar + ir * NT * T + s * n_off
        + s * NT * T, 2 * NT * T + n_ent + n_tfar, dtype, (E + 3, scale), **reps)
    n_last, n_prev = int((d["g_last"] >= 0).sum()), int((d["g_prev"] >= 0).sum())
    n_pk = int((d["ent_slot"] >= 0).sum())
    d_args = (x, *d1, t["rout"], shape, True)
    rows["tile_down_a" + sfx] = _measure(
        "tile_down_a" + sfx, lambda: kernels.tile_down_a(*d_args, tile0=0),
        lambda: kernels.tile_down_a_plain(*d_args, tile0=0), None,
        s * n + 2 * ix * NT * T + ix * (n_last + n_prev) + _index_bytes(T + 1) * NT
        + (ix + s) * n_pk + (ir + s) * NT * T, 3 * NT * T + n_prev, dtype,
        (2 * T, float(tile_x.max())), **reps)
    n_tree = int(d["n_tree"].sum())
    l_args = (abar_t, A, d["tree_of"], t["rout"], shape)
    rows["tile_down_lite" + sfx] = _measure(
        "tile_down_lite" + sfx, lambda: kernels.tile_down_lite(*l_args, tile0=0),
        lambda: kernels.tile_down_lite_plain(*l_args, tile0=0), None,
        # abar read and out written per cell, rout per cell and tree_of per
        # tree slot (its tree, of R_pad), A per real root; one add per tree cell
        2 * s * NT * T + ir * NT * T + _index_bytes(tp.R_pad) * n_tree + s * n_roots, n_tree,
        dtype, **reps)
    return rows


def _start_group():
    """This process as a process group of one rank over NCCL, on card 0,
    through a TCP rendezvous on a free local port."""
    import datetime
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))


def sharded_path(fl, d8, seq, dev):
    """The sharded sweeps on this process's one-rank NCCL group, on the
    6000x6000 grid's D8 through ``build_sharded_plan`` (padded to
    6016x6016); ``fl`` is the grid's raster object, ``seq`` its cells with
    downstream ones first. Returns the kernel rows and timings."""
    import torch.distributed as dist

    from pyflwdir_torch import kernels, parallel, runtime
    from pyflwdir_torch.ops.tile_plan import _CoarseRouterSmall

    print(" sharded path:")
    t_path = time.perf_counter()
    mesh = parallel.make_mesh()
    _check(mesh.size == dist.get_world_size() == 1 and dist.get_backend(mesh.group) == "nccl",
           f"a mesh of the one rank of the NCCL group: {mesh}")
    t0 = time.perf_counter()
    tp, pshape = parallel.build_sharded_plan(d8, mesh)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp._ensure_down()
    t_down = time.perf_counter() - t0
    print(f"  setup: build_sharded_plan {t_build:.2f} s, down indices {t_down:.2f} s; shape "
          f"{pshape}, NT {tp.NT}, R_pad {tp.R_pad}, E_pad {tp.E_pad}")
    _check(tuple(pshape) == (6016, 6016) and tp.NT == 2209 and tp.has_entries
           and isinstance(tp.coarse, _CoarseRouterSmall),
           "build_sharded_plan padded the grid to 6016x6016 (NT 2209) with a "
           "_CoarseRouterSmall coarse level and entry cells")
    rows = {}
    for dtype in (torch.int32, torch.float64):
        print(f" kernel phase, lite mode and tile ranges ({_DT[dtype]}):")
        rows[dtype] = sharded_kernel_phase(tp, dtype, dev)

    print(" main path, sharded (one rank):")
    H, W = TILE_SHAPE
    rng = np.random.RandomState(SEED + 8)
    w = np.zeros(pshape, np.int32)
    w[:H, :W] = rng.randint(0, 3, (H, W))
    f = np.zeros(pshape)
    f[:H, :W] = rng.rand(H, W)
    xs = {torch.int32: torch.as_tensor(w.ravel(), device=dev),
          torch.float64: torch.as_tensor(f.ravel(), device=dev)}
    chunks = 2  # accumulate_sharded's default, dropped until it divides the slab
    while (tp.NT // mesh.size) % chunks:
        chunks -= 1
    counts, res = {}, {}
    for dtype, x in xs.items():
        kernels.reset_launches()
        res[dtype] = (tp.accumulate_sharded(x, mesh), tp.accumulate_down_sharded(x, mesh))
        torch.cuda.synchronize()
        counts[dtype] = dict(kernels.launches)
        print(f"  {_DT[dtype]}: launches {counts[dtype]}")
    fz = f[:H, :W].astype(np.float32)
    kernels.reset_launches()
    t0 = time.perf_counter()
    ta = parallel.tiled_accumulate(d8, fz, mesh, method="plan")
    t_ta = time.perf_counter() - t0
    counts_ta = dict(kernels.launches)
    print(f"  tiled_accumulate(method='plan') {t_ta:.2f} s (with its plan build); launches "
          f"{counts_ta}")
    # the coarse level: H1, H2, H3 once upward; H1 twice, H0 four times down
    want = {"tile_pass_a": chunks, "tile_pass_c": 1, "tile_down_a": 1, "tile_down_lite": 1,
            "accel_in_scan": 3, "accel_near_out": 1, "permute_gather": 4, "accel_far_merge": 1}
    for dtype, c in counts.items():
        _check(all(c[k] == want.get(k, 0) for k in c),
               f"accumulate_sharded and accumulate_down_sharded ({_DT[dtype]}) launched T1 "
               f"{chunks}x, T2, the coarse level's kernels, T3 routed and T4 lite once each "
               "(once a downward call), and no raw T3 or T4 fin")
    want_ta = {"tile_pass_a": chunks, "tile_pass_c": 1, "accel_in_scan": 1, "accel_near_out": 1,
               "accel_far_merge": 1}
    _check(all(counts_ta[k] == want_ta.get(k, 0) for k in counts_ta),
           "tiled_accumulate(method='plan') launched the sharded upward sweep's kernels")

    t0 = time.perf_counter()
    mask, ids = fl.mask, fl.idxs_ds
    for dtype, x in xs.items():
        up, down = res[dtype]
        _check(torch.equal(up, tp.accumulate(x)) and torch.equal(down, tp.accumulate_down(x)),
               f"accumulate_sharded and accumulate_down_sharded ({_DT[dtype]}) bitwise equal to "
               "the same plan's accumulate and accumulate_down")
    pad = np.ones(pshape, bool)
    pad[:H, :W] = False
    cut = [r.cpu().numpy().reshape(pshape) for r in res[torch.int32]]
    _check(all(r.dtype == np.int32 and not r[pad].any() for r in cut),
           "int32 results, 0 on the padding")
    wv = w[:H, :W].ravel().astype(np.float64)
    want_up = runtime.accuflux_sweep(ids, seq, wv)
    want_dn = runtime.downward_sweep(ids, seq, wv)
    up_i, dn_i = (r[:H, :W].ravel() for r in cut)
    _check(np.array_equal(up_i[mask], want_up[mask].astype(np.int32))
           and np.array_equal(dn_i[mask], want_dn[mask].astype(np.int32)),
           "int32 accumulate_sharded and accumulate_down_sharded bitwise equal to the native "
           "sequential sweeps")
    fv = f[:H, :W].ravel()
    up_f, dn_f = (r.cpu().numpy().reshape(pshape)[:H, :W].ravel() for r in res[torch.float64])
    n_c = tp.coarse._down_t["es_in"].numel()
    length_up = 128 * 128 + 2 * _scan_len(tp.coarse.n_pad) + tp.E_pad
    _close(up_f[mask], runtime.accuflux_sweep(ids, seq, fv)[mask], length_up,
           float(fv[mask].sum()), "accumulate_sharded(float64) of the native sweep")
    _close(dn_f[mask], runtime.downward_sweep(ids, seq, fv)[mask],
           2 * (128 * 128 + 2 * _scan_len(n_c)), float(fv[mask].sum()),
           "accumulate_down_sharded(float64) of the native downward sweep")
    want_ta = runtime.accuflux_sweep(ids, seq, fz.ravel().astype(np.float64)).reshape(H, W)
    m2 = mask.reshape(H, W)
    atol = 2 * length_up * _EPS * float(fz[m2].sum(dtype=np.float64))
    _check(ta.dtype == np.float32 and ta.shape == (H, W)
           and np.allclose(ta[m2], want_ta[m2], rtol=1e-6, atol=atol),
           f"tiled_accumulate(method='plan') float32 of the grid's shape, within rtol 1e-6 (the "
           f"float32 rounding of float64 sums), atol 2 L eps total = {atol:.3e} of the native "
           "sweep")
    print(f"  checks {time.perf_counter() - t0:.2f} s")
    del res, cut

    ones = torch.ones(pshape[0] * pshape[1], dtype=torch.int32, device=dev)
    times = {}
    for name, fn in (("accumulate_sharded", lambda: tp.accumulate_sharded(ones, mesh)),
                     ("accumulate", lambda: tp.accumulate(ones)),
                     ("accumulate_down_sharded", lambda: tp.accumulate_down_sharded(ones, mesh)),
                     ("accumulate_down", lambda: tp.accumulate_down(ones))):
        times[name + "_ms"] = _time_ms(fn, reps=20, warmup=3)
        times[name + "_device_ms"] = _device_ms(fn)
    T = 128 * 128
    ex = torch.zeros((tp.NT, tp.R_pad), dtype=torch.int32, device=dev)
    pk = torch.zeros((tp.NT, tp.E_pad), dtype=torch.int32, device=dev)
    stack = torch.zeros((tp.NT, T), dtype=torch.int32, device=dev)
    times["gather_exits_ms"] = _time_ms(lambda: mesh.all_gather(ex), reps=20)
    times["gather_entries_ms"] = _time_ms(lambda: mesh.all_gather(pk), reps=20)
    times["gather_result_ms"] = _time_ms(lambda: mesh.all_gather(stack), reps=20)
    times["gather_tiles_ms"] = _time_ms(lambda: tp.gather_tiles(stack, mesh), reps=20)
    print("  one rank, int32, wall (CUDA events) / device: " + ", ".join(
        f"{k} {times[k + '_ms']:.4f} / {times[k + '_device_ms']} ms"
        for k in ("accumulate_sharded", "accumulate", "accumulate_down_sharded",
                  "accumulate_down")))
    print(f"  all_gather over NCCL of the exits ({ex.numel()} int32) "
          f"{times['gather_exits_ms']:.4f} ms, of the entry values ({pk.numel()}) "
          f"{times['gather_entries_ms']:.4f} ms, of the result stack ({stack.numel()}) "
          f"{times['gather_result_ms']:.4f} ms; with its untiling (gather_tiles) "
          f"{times['gather_tiles_ms']:.4f} ms")
    del ones, ex, pk, stack
    t_path = time.perf_counter() - t_path
    print(f"  sharded path {t_path:.1f} s")
    path = "tile 6016x6016 sharded, 1 rank"
    krows = _rows(rows[torch.int32], counts[torch.int32], path, "int32")
    krows += _rows(rows[torch.float64], counts[torch.float64], path, "float64")
    return krows, dict(times, build_s=t_build, down_indices_s=t_down, chunks=chunks,
                       tiled_accumulate_s=t_ta, path_s=t_path, NT=tp.NT, pshape=list(pshape))


def _tall_ranges(tp):
    """Two tile ranges of the plan's grid that start and end in the middle of
    a tile row, the second ending the grid."""
    ntx, nt = tp.grid[1], tp.NT
    mid = (tp.grid[0] // 2) * ntx + ntx // 2
    return ((ntx // 3, mid), (mid, nt))


def tall_path(fl, tp, d8, upa, seq, refs, dev):
    """Tile plans of 256, 384 and 512 rows on the 6000x6000 grid (kernels
    T1-T4 as thread-block clusters of 2, 3 and 4 CTAs a tile). For each
    height: the build by step; int32 ``accumulate`` and ``accumulate_down``
    bitwise the 128-row plan ``tp``'s and the native sweeps'; float64 by the
    rule with the chain length at T = 128 Y, two calls the same bits; the
    launch counters zeroed before each call and read after: the cluster
    kernels ran, no 128-row one. At each height a kernel phase (every mode
    and the tile-range forms against their plain versions), the banded and
    the one-rank sharded sweeps on the main path; at 512 rows a saved
    plan, its ``load_plans`` into a new raster and that raster's
    ``upstream_area()``, ``stream_distance()`` and ``stream_order()``
    bitwise the 128-row results, ``build_sharded_plan(tile_rows=512)`` and
    the closed tiles of the routed path at 512 rows. Returns the kernel rows
    and timings."""
    import torch.distributed as dist

    import pyflwdir_torch
    from pyflwdir_torch import kernels, parallel, runtime
    from pyflwdir_torch.ops.tile_plan import build_tile_plan

    print(" tall tiles (T1-T4 as thread-block clusters):")
    t_path = time.perf_counter()
    H, W = fl.shape
    n = H * W
    mask, ids = fl.mask, fl.idxs_ds
    rng = np.random.RandomState(SEED + 12)
    fdata = rng.rand(n)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    fx = torch.as_tensor(fdata, device=dev)
    want_up = {torch.int32: tp.accumulate(ones), torch.float64: None}
    want_dn = {torch.int32: tp.accumulate_down(ones), torch.float64: None}
    sweep_dn = runtime.downward_sweep(ids, seq, np.ones(n))
    f_up = runtime.accuflux_sweep(ids, seq, fdata)
    f_dn = runtime.downward_sweep(ids, seq, fdata)
    mesh = parallel.make_mesh()
    _check(mesh.size == 1 and dist.get_backend(mesh.group) == "nccl",
           f"a mesh of the one rank of the NCCL group: {mesh}")
    tile_names = kernels._TILE_COUNTS
    krows, out = [], {}
    for Y in TALL_ROWS:
        G = Y // 128
        g = f"_g{G}"
        print(f" tall tiles, {Y} rows (clusters of {G} CTAs):")
        t0 = time.perf_counter()
        ty = build_tile_plan(ids, fl.shape, tile_rows=Y, device=dev)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        ty._ensure_down()
        t_down = time.perf_counter() - t0
        t0 = time.perf_counter()
        up_t, down_t = ty.idx_t, ty.down_idx_t
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        steps = ", ".join(f"{k} {v:.2f}" for k, v in ty.build_seconds.items())
        dsteps = ", ".join(f"{k} {v:.2f}" for k, v in ty.down_build_seconds.items())
        T = Y * 128
        card_bytes = sum(v.numel() * v.element_size() for v in (*up_t.values(), *down_t.values()))
        print(f"  build {t_build:.2f} s ({steps}); down indices {t_down:.2f} s ({dsteps}); "
              f"upload {t_upload:.2f} s, {card_bytes} bytes on the card; NT {ty.NT}, grid "
              f"{ty.grid}, R_pad {ty.R_pad}, E_pad {ty.E_pad}, far_mode {ty.far_mode}, coarse "
              f"{type(ty.coarse).__name__}, {ty._coarse_meta['m']} roots + "
              f"{ty._coarse_meta['D']} entry nodes")
        _check(ty.Y == Y and ty.G == G and ty.grid == (-(-H // Y), -(-W // 128))
               and up_t["rin"].shape == (ty.NT, T)
               and up_t["rin"].dtype == kernels.tile_table_dtype(Y) and ty.has_entries,
               f"a plan of {Y}-row tiles: grid {ty.grid}, NT {ty.NT}, {up_t['rin'].dtype} "
               "tables of T = 128 Y slots, entry cells")

        rows = {torch.int32: {}, torch.float64: {}}
        tag = f".y{Y}"
        for dtype in (torch.int32, torch.float64):
            print(f"  kernel phase ({_DT[dtype]}):")
            r = rows[dtype]
            r.update(tile_kernel_phase(ty, dtype, dev, tag, coarse=False))
            r.update(tile_down_kernel_phase(ty, dtype, dev, tag, coarse=False))
            r.update(banded_kernel_phase(ty, dtype, dev, tag))
            r.update(sharded_kernel_phase(ty, dtype, dev, tag, _tall_ranges(ty)))

        print("  main path:")
        sh = ty
        if Y == 512:
            t0 = time.perf_counter()
            sh, pshape = parallel.build_sharded_plan(d8, mesh, tile_rows=Y)
            sh._ensure_down()
            t_sh = time.perf_counter() - t0
            print(f"  build_sharded_plan(tile_rows={Y}) and its down indices {t_sh:.2f} s; "
                  f"shape {pshape}, NT {sh.NT}")
            _check(tuple(pshape) == (-(-H // Y) * Y, -(-W // 128) * 128) and sh.Y == Y,
                   f"build_sharded_plan padded the grid to {pshape} at {Y} rows")
            out.setdefault("sharded_build_s", t_sh)
        nb = -(-ty.grid[0] // TALL_BAND_TILE_ROWS)
        calls = {}
        for dtype, x in ((torch.int32, ones), (torch.float64, fx)):
            dt = _DT[dtype]
            calls[f"accumulate {dt}"] = (lambda x=x: ty.accumulate(x),
                                         {"tile_pass_a" + g: 1, "tile_pass_c" + g: 1})
            calls[f"accumulate_down {dt}"] = (lambda x=x: ty.accumulate_down(x),
                                              {"tile_down_a" + g: 1, "tile_down_fin" + g: 1})
            host = x.cpu().numpy().reshape(H, W) if dtype == torch.float64 else None
            calls[f"accumulate_banded {dt}"] = (
                lambda host=host: ty.accumulate_banded(host, TALL_BAND_TILE_ROWS),
                {"tile_pass_a_exits" + g: nb, "tile_pass_c_full" + g: nb})
            xs = x
            if sh is not ty:
                xs = torch.zeros(sh.shape, dtype=x.dtype, device=dev)
                xs[:H, :W] = x.reshape(H, W)
                xs = xs.reshape(-1)
            calls[f"sharded {dt}"] = (
                lambda xs=xs: (sh.accumulate_sharded(xs, mesh, overlap_chunks=1),
                               sh.accumulate_down_sharded(xs, mesh)),
                {"tile_pass_a" + g: 1, "tile_pass_c" + g: 1, "tile_down_a" + g: 1,
                 "tile_down_lite" + g: 1})
        res, counts = {}, {torch.int32: {}, torch.float64: {}}
        for name, (fn, want) in calls.items():
            kernels.reset_launches()
            res[name] = fn()
            torch.cuda.synchronize()
            c = dict(kernels.launches)
            dtype = torch.int32 if "int32" in name else torch.float64
            for k, v in c.items():
                counts[dtype][k] = counts[dtype].get(k, 0) + v
            _check(all(c[k] == want.get(k, 0) for k in c if k.startswith("tile_"))
                   and not any(c[k] for k in tile_names),
                   f"{name} ({Y} rows) launched the {G}-CTA cluster kernels "
                   f"{sorted(want)} and no 128-row tile kernel: "
                   f"{({k: v for k, v in c.items() if v})}")

        t0 = time.perf_counter()
        up_i, dn_i = res["accumulate int32"], res["accumulate_down int32"]
        _check(torch.equal(up_i, want_up[torch.int32])
               and np.array_equal(up_i.cpu().numpy().reshape(H, W)[mask.reshape(H, W)],
                                  upa[mask.reshape(H, W)]),
               f"int32 accumulate ({Y} rows) bitwise the 128-row plan's and the native sweep's")
        _check(torch.equal(dn_i, want_dn[torch.int32])
               and np.array_equal(dn_i.cpu().numpy()[mask], sweep_dn[mask].astype(np.int32)),
               f"int32 accumulate_down ({Y} rows) bitwise the 128-row plan's and the native "
               "downward sweep's")
        # a value sums a tile's prefix (T = 128 Y slots), the coarse level's
        # prefix and its tile's entry scan (E_pad), in another order
        n_pad = getattr(ty.coarse, "n_pad", ty.NT * ty.R_pad)
        length = T + 2 * _scan_len(n_pad) + ty.E_pad
        up_f, dn_f = res["accumulate float64"], res["accumulate_down float64"]
        _close(up_f.cpu().numpy()[mask], f_up[mask], length, float(fdata[mask].sum()),
               f"float64 accumulate ({Y} rows) of the native sweep")
        n_c = ty.coarse._down_t["es_in"].numel() if hasattr(ty.coarse, "_down_t") else n_pad
        _close(dn_f.cpu().numpy()[mask], f_dn[mask], 2 * (T + 2 * _scan_len(n_c)),
               float(fdata[mask].sum()), f"float64 accumulate_down ({Y} rows) of the native "
               "downward sweep")
        _check(torch.equal(ty.accumulate(fx), up_f) and torch.equal(ty.accumulate_down(fx), dn_f),
               f"two float64 calls ({Y} rows) give the same bits")
        for dtype, dt in ((torch.int32, "int32"), (torch.float64, "float64")):
            b = res[f"accumulate_banded {dt}"]
            mono = res[f"accumulate {dt}"].cpu().numpy().reshape(H, W)
            _check(np.array_equal(b, mono.astype(b.dtype)),
                   f"accumulate_banded ({dt}, {Y} rows, {nb} bands) bitwise accumulate")
            su, sd = res[f"sharded {dt}"]
            xs = ones if dt == "int32" else fx
            if sh is not ty:
                xs = torch.zeros(sh.shape, dtype=xs.dtype, device=dev)
                xs[:H, :W] = (ones if dt == "int32" else fx).reshape(H, W)
                xs = xs.reshape(-1)
            _check(torch.equal(su, sh.accumulate(xs))
                   and torch.equal(sd, sh.accumulate_down(xs)),
                   f"one-rank accumulate_sharded / accumulate_down_sharded ({dt}, {Y} "
                   "rows) bitwise the same plan's unsharded sweeps")
            if sh is not ty and dt == "int32":
                crop = [r.reshape(sh.shape)[:H, :W].reshape(-1) for r in (su, sd)]
                _check(torch.equal(crop[0], up_i) and torch.equal(crop[1], dn_i),
                       f"... and, on the grid, the {Y}-row plan's int32 results")
        print(f"  checks {time.perf_counter() - t0:.2f} s")

        times = {}
        for name, fn in (("accumulate_int32", lambda: ty.accumulate(ones)),
                         ("accumulate_down_int32", lambda: ty.accumulate_down(ones)),
                         ("accumulate_float64", lambda: ty.accumulate(fx)),
                         ("accumulate_down_float64", lambda: ty.accumulate_down(fx))):
            times[name + "_ms"] = _time_ms(fn, reps=20, warmup=3)
            times[name + "_device_ms"] = _device_ms(fn)
        print(f"  wall (CUDA events) / device, ms: " + ", ".join(
            f"{k[:-3]} {times[k]:.4f} / {times[k[:-3] + '_device_ms']}"
            for k in times if not k.endswith("_device_ms")))

        rrows = {}
        if Y == 512:
            out["saved_plan"] = _tall_saved(fl, ty, upa, refs, dev)
            del sh
            rrows, out["closed_tiles"] = _tall_closed(Y, dev)
        # each path's rows read the launches of that path's own run: the
        # closed tiles are a grid and a call of their own
        rh, rw = ROUTED_SHAPE
        for dtype in (torch.int32, torch.float64):
            r = _rows(rows[dtype], counts[dtype], f"tile {H}x{W}, {Y}-row tiles", _DT[dtype], G)
            if dtype in rrows:
                r += _rows(rrows[dtype]["rows"], rrows[dtype]["counts"],
                           f"closed tiles {rh}x{rw}, {Y}-row tiles", _DT[dtype], G)
            _check(all(row["launches"] > 0 for row in r),
                   f"every kernel of the {Y}-row phase ({_DT[dtype]}) launched on its main path")
            krows += r
        out[f"y{Y}"] = dict(build_s=t_build, build_steps_s=ty.build_seconds,
                            down_indices_s=t_down, down_steps_s=ty.down_build_seconds,
                            upload_s=t_upload, card_table_bytes=card_bytes, NT=ty.NT,
                            R_pad=ty.R_pad, E_pad=ty.E_pad, far_mode=ty.far_mode,
                            coarse=type(ty.coarse).__name__, **times)
        del ty, res, up_t, down_t
        torch.cuda.empty_cache()
    t_path = time.perf_counter() - t_path
    out["path_s"] = t_path
    print(f"  tall-tile phase {t_path:.1f} s")
    return krows, out


def _tall_saved(fl, ty, upa, refs, dev):
    """Save the tall plan ``ty`` (the port's format), load it into a new
    raster object with ``load_plans`` (no build step may run) and hold its
    ``upstream_area()``, ``stream_distance()`` and ``stream_order()``
    bitwise to the 128-row plan's results."""
    import pyflwdir_torch
    from pyflwdir_torch import kernels

    g = f"_g{ty.G}"
    plan_dir = tempfile.mkdtemp(prefix="_plan_tmp", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        t0 = time.perf_counter()
        meta = ty.save(plan_dir, down=True)
        t_save = time.perf_counter() - t0
        with _Rebuilds() as rb:
            fl2 = pyflwdir_torch.FlwdirRaster(fl.idxs_ds, fl.shape, "d8", fl.idxs_pit,
                                              transform=fl.transform, latlon=fl.latlon,
                                              device=fl.device)
            t0 = time.perf_counter()
            tp2 = fl2.load_plans(plan_dir)
            t_load = time.perf_counter() - t0
            kernels.reset_launches()
            t0 = time.perf_counter()
            upa2 = fl2.upstream_area()
            t_first = time.perf_counter() - t0
            c_up = dict(kernels.launches)
            kernels.reset_launches()
            t0 = time.perf_counter()
            dist2 = fl2.stream_distance()
            t_dist = time.perf_counter() - t0
            c_dn = dict(kernels.launches)
            kernels.reset_launches()
            t0 = time.perf_counter()
            strord2 = fl2.stream_order()
            t_ord = time.perf_counter() - t0
            c_ord = dict(kernels.launches)
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
    print(f"  saved plan ({ty.Y} rows): save {t_save:.3f} s, load_plans {t_load:.3f} s, first "
          f"upstream_area() {t_first:.3f} s, stream_distance() {t_dist:.3f} s, stream_order() "
          f"{t_ord:.3f} s")
    _check(meta["tile_rows"] == ty.Y and tp2.Y == ty.Y and not rb.calls,
           f"the saved plan keeps tile_rows {ty.Y}; load_plans and the calls after it ran no "
           f"build step ({rb.calls})")
    _check(c_up["tile_pass_a" + g] == c_up["tile_pass_c" + g] == 1
           and c_dn["tile_down_a" + g] == 1 and c_ord["tile_pass_a" + g] >= 1
           and not any(c[k] for c in (c_up, c_dn, c_ord) for k in kernels._TILE_COUNTS),
           f"the loaded raster's calls ran the {ty.G}-CTA cluster kernels")
    _check(np.array_equal(upa2, upa) and np.array_equal(dist2, refs["stream_distance"])
           and np.array_equal(strord2, fl.stream_order()),
           f"upstream_area(), stream_distance() and stream_order() of the loaded {ty.Y}-row "
           "plan bitwise the 128-row plan's")
    return dict(save_s=t_save, load_s=t_load, first_upstream_area_s=t_first,
                stream_distance_s=t_dist, stream_order_s=t_ord)


def _tall_closed(Y, dev):
    """T3 routed alone on the routed path's closed tiles at ``Y`` rows (a
    tile closed at 128 rows is closed at 128 G): bitwise the 128-row plan's
    ``accumulate_down``; its kernel rows in int32 and float64 with the
    launches of one downward call each."""
    from pyflwdir_torch import kernels
    from pyflwdir_torch.codecs import d8 as d8c
    from pyflwdir_torch.ops.tile_plan import build_tile_plan

    d8 = np.ones(ROUTED_SHAPE, np.uint8)
    d8[:, 127::128] = 4
    d8[127::128, 127::128] = 0
    d8[:40, 0] = 247
    ids = d8c.from_array(d8)[0]
    n = ids.size
    tp128 = build_tile_plan(ids, ROUTED_SHAPE, device=dev)
    ty = build_tile_plan(ids, ROUTED_SHAPE, tile_rows=Y, device=dev)
    ty._ensure_down()
    _check(not ty.has_entries and ty.E_pad == 0,
           f"the closed tiles at {Y} rows: no entry cells")
    out, info = {}, {}
    for dtype in (torch.int32, torch.float64):
        x = _down_data(n, dtype, dev)
        kernels.reset_launches()
        got = ty.accumulate_down(x)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        g = f"tile_down_a_g{Y // 128}"
        _check(all(counts[k] == (k == g) for k in counts),
               f"accumulate_down ({_DT[dtype]}, closed tiles, {Y} rows) launched T3 once, "
               f"routed, and no other kernel: {({k: v for k, v in counts.items() if v})}")
        want = tp128.accumulate_down(x)
        if dtype == torch.int32:
            _check(torch.equal(got, want), f"... bitwise the 128-row plan's ({_DT[dtype]})")
        else:
            total = float(x.abs().sum())
            _close(got.cpu().numpy(), want.cpu().numpy(), 4 * Y * 128, total,
                   f"... the 128-row plan's ({_DT[dtype]})")
        rows, _, _ = tile_down_a_rows(ty, dtype, dev, ("routed",), f".noentry.y{Y}")
        ms = _time_ms(lambda: ty.accumulate_down(x), reps=20, warmup=3)
        info[_DT[dtype] + "_ms"] = ms
        out[dtype] = dict(rows=rows, counts=counts)
    print(f"  closed tiles {ROUTED_SHAPE} at {Y} rows: accumulate_down (T3 routed alone) "
          f"int32 {info['int32_ms']:.4f} ms, float64 {info['float64_ms']:.4f} ms")
    return out, info


def _sharded_rank(rank, world, port, work_dir, device_type):
    """One spawned rank of :func:`multi_card_path`: joins the group, loads
    the plan rank 0 built and saved (memory-mapped), runs both sharded
    sweeps in int32 and float64 against the unsharded ones on its own
    device, times them, and writes ``rank<r>.json`` into ``work_dir``."""
    import torch.distributed as dist

    from pyflwdir_torch import kernels, parallel
    from pyflwdir_torch.ops.tile_plan import TilePlan

    cuda = device_type == "cuda"
    os.environ["LOCAL_RANK"] = str(rank)
    parallel.init_distributed(f"localhost:{port}", world, rank, device=None if cuda else "cpu")
    mesh = parallel.make_mesh(device=None if cuda else "cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    plan_dir = os.path.join(work_dir, "plan")
    t0 = time.perf_counter()
    if rank == 0:
        tp, pshape = parallel.build_sharded_plan(np.load(os.path.join(work_dir, "d8.npy")), mesh)
        tp.save(plan_dir, down=True)
    dist.barrier()
    if rank > 0:
        tp = TilePlan.load(plan_dir, mmap=True, device=mesh.device)
    t_plan = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 9)
    n = tp.shape[0] * tp.shape[1]
    out = dict(rank=rank, world=world, device=str(mesh.device), plan_s=t_plan, NT=tp.NT,
               slab=tp.NT // world, ok=True)
    for dtype, x in ((torch.int32, torch.as_tensor(rng.randint(0, 3, n).astype(np.int32))),
                     (torch.float64, torch.as_tensor(rng.rand(n)))):
        x = x.to(mesh.device)
        kernels.reset_launches()
        up, down = tp.accumulate_sharded(x, mesh), tp.accumulate_down_sharded(x, mesh)
        sync()
        out[f"launches.{_DT[dtype]}"] = dict(kernels.launches)
        out[f"ok.{_DT[dtype]}"] = bool(torch.equal(up, tp.accumulate(x))
                                       and torch.equal(down, tp.accumulate_down(x)))
        out["ok"] &= out[f"ok.{_DT[dtype]}"] and kernels.launches["tile_down_lite"] == 1
    if cuda:
        ones = torch.ones(n, dtype=torch.int32, device=mesh.device)
        for name, fn in (("accumulate_sharded", lambda: tp.accumulate_sharded(ones, mesh)),
                         ("accumulate_down_sharded",
                          lambda: tp.accumulate_down_sharded(ones, mesh))):
            out[name + "_ms"] = _time_ms(fn, reps=10, warmup=2)
    del tp
    if os.path.exists(os.path.join(work_dir, "halo.npz")):
        out["halo"] = _halo_rank(mesh, work_dir, sync)
    with open(os.path.join(work_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


def _halo_rank(mesh, work_dir, sync):
    """The halo functions of the halo phase on this rank's mesh, on the
    inputs in ``halo.npz``: each one timed (host clock, synchronised), the
    launches read, and a digest of its result; rank 0 also writes the
    results to ``halo_rank0.npz``."""
    import hashlib

    from pyflwdir_torch import kernels
    from pyflwdir_torch.parallel import tiled

    inp = np.load(os.path.join(work_dir, "halo.npz"))
    d8 = inp["d8"]
    wts = np.random.RandomState(HALO_SEED).rand(*d8.shape).astype(np.float32)
    calls = _halo_calls(d8, inp["z"], inp["elev"], inp["drain"], wts, inp["idxs_pit"],
                        TILE_LATLON, mesh)
    out, res = {}, {}
    for name, fn in calls.items():
        kernels.reset_launches()
        sync()
        t0 = time.perf_counter()
        res[name] = fn()
        sync()
        out[name] = dict(s=time.perf_counter() - t0, rounds=dict(tiled.last_rounds),
                         launches={k: v for k, v in kernels.launches.items() if v},
                         digest=hashlib.sha1(np.ascontiguousarray(res[name])).hexdigest())
    if mesh.rank == 0:
        np.savez(os.path.join(work_dir, "halo_rank0.npz"), **res)
    return out


def _check_halo_ranks(ranks, world, work_dir, halo):
    """The halo functions on ``world`` ranks: every rank the same result
    (digests); integer results, the unit sums, HAND and the fill bitwise the
    one-rank results ``halo["ref"]``; the float32 weights' sums within twice
    the one-rank rule (two float32 roundings of float64 sums), the metric
    distances within the JAX tests' rtol 1e-5."""
    ref = halo["ref"]
    got = dict(np.load(os.path.join(work_dir, "halo_rank0.npz")))
    names = list(ref)
    _check(all(r["halo"][k]["digest"] == ranks[0]["halo"][k]["digest"]
               for r in ranks for k in names),
           f"on {world} ranks, every rank returned the same halo results")
    floats = ("tiled_accumulate_weights", "tiled_stream_distance_m")
    _check(all(np.array_equal(got[k], ref[k]) for k in names if k not in floats),
           f"on {world} ranks, the integer halo results, the unit sums, tiled_hand and "
           "tiled_fill bitwise equal to the one-rank results")
    a, b = got["tiled_accumulate_weights"], ref["tiled_accumulate_weights"]
    _check(bool(np.all(np.abs(a - b) <= 2 * halo["acc_rtol"] * np.abs(b))),
           f"on {world} ranks, tiled_accumulate(weights) within 2 x {halo['acc_rtol']:.3e} of "
           "the one-rank result")
    a, b = got["tiled_stream_distance_m"], ref["tiled_stream_distance_m"]
    _check(np.allclose(a, b, rtol=1e-5), f"on {world} ranks, the metric distances within rtol "
           "1e-5 of the one-rank result")
    f1 = ranks[0]["halo"]["tiled_fill"]
    _check(f1["launches"].get("fill_sweep", 0) == 2 * f1["rounds"]["fill"] > 0,
           f"on {world} ranks, tiled_fill launched F1 twice a round")
    for r in ranks:
        print(f"  rank {r['rank']} halo: " + ", ".join(
            f"{k} {v['s']:.3f} s" for k, v in r["halo"].items())
              + f"; fill rounds {r['halo']['tiled_fill']['rounds']['fill']}, iterate rounds "
              f"{r['halo']['tiled_accumulate_iterate']['rounds']['accumulate']}")


def multi_card_path(d8, n_cards, device_type="cuda", halo=None):
    """Where the machine has more than one card: the sharded sweeps at world
    sizes 2 and 4, as the cards allow, one spawned rank per card over NCCL
    (gloo where ``device_type`` is "cpu"), each holding its results bitwise
    against the unsharded sweeps on its own card. Returns what each rank
    wrote."""
    import multiprocessing
    import socket

    worlds = [w for w in (2, 4) if w <= n_cards]
    out = {}
    for world in worlds:
        print(f"sharded path on {world} cards (spawned ranks):")
        work_dir = tempfile.mkdtemp(prefix="_plan_tmp",
                                    dir=os.path.dirname(os.path.abspath(__file__)))
        try:
            np.save(os.path.join(work_dir, "d8.npy"), d8)
            if halo is not None:
                np.savez(os.path.join(work_dir, "halo.npz"), d8=d8,
                         **{k: halo[k] for k in ("z", "elev", "drain", "idxs_pit")})
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            ctx = multiprocessing.get_context("spawn")
            procs = [ctx.Process(target=_sharded_rank,
                                 args=(r, world, port, work_dir, device_type))
                     for r in range(world)]
            t0 = time.perf_counter()
            for p in procs:
                p.start()
            for p in procs:
                p.join(max(1.0, 600 - (time.perf_counter() - t0)))
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            _check(not alive and all(p.exitcode == 0 for p in procs),
                   f"{world} ranks ran to their end ({[p.exitcode for p in procs]}), in "
                   f"{time.perf_counter() - t0:.1f} s")
            ranks = []
            for r in range(world):
                with open(os.path.join(work_dir, f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
            if halo is not None:
                _check_halo_ranks(ranks, world, work_dir, halo)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        for res in ranks:
            print(f"  rank {res['rank']} on {res['device']}: plan {res['plan_s']:.2f} s, "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in res.items() if k.endswith("_ms")))
        _check(all(res["ok"] for res in ranks),
               f"on {world} ranks, accumulate_sharded and accumulate_down_sharded (int32, "
               "float64) bitwise equal to the unsharded sweeps on every rank, T4 lite "
               "launched once a downward call")
        out[world] = ranks
    return out


HALO_SEED = SEED + 10  # the halo phase's float32 weights


def _halo_rules(n_cells):
    """The halo phase's float32 rules: ``(acc_rtol, dist_rtol)``. A float
    accumulation is a float64 sum of non-negative terms (any order within
    n eps64 of the value) rounded to float32 once, against the tile plan's
    float64 sum: 2^-24 + 2 n eps64. A metric distance is a float32 path sum
    by doubling (a tree of at most ``_n_rounds(n)`` levels of float32
    additions of non-negative steps) against the float64 sum of the same
    float32 steps: (rounds + 1) 2^-24."""
    from pyflwdir_torch.ops.graph import _n_rounds

    return 2.0 ** -24 + 2 * n_cells * _EPS, (_n_rounds(n_cells) + 1) * 2.0 ** -24


def _halo_calls(d8, z, elev, drain, wts, idxs_pit, transform, mesh):
    """The halo functions of the halo phase on ``mesh``, by name."""
    from pyflwdir_torch import parallel

    return {
        "tiled_accumulate_coarse": lambda: parallel.tiled_accumulate(
            d8, np.ones(d8.shape, np.float32), mesh),
        "tiled_accumulate_iterate": lambda: parallel.tiled_accumulate(
            d8, np.ones(d8.shape, np.float32), mesh, method="iterate"),
        "tiled_accumulate_weights": lambda: parallel.tiled_accumulate(d8, wts, mesh),
        "tiled_rank": lambda: parallel.tiled_rank(d8, mesh),
        "tiled_basins": lambda: parallel.tiled_basins(d8, idxs_pit, mesh),
        "tiled_stream_distance_cells": lambda: parallel.tiled_stream_distance(
            d8, mesh, real_length=False),
        "tiled_stream_distance_m": lambda: parallel.tiled_stream_distance(
            d8, mesh, latlon=True, transform=transform),
        "tiled_hand": lambda: parallel.tiled_hand(d8, elev, drain, mesh),
        "tiled_strahler": lambda: parallel.tiled_strahler(d8, mesh),
        "tiled_fill": lambda: parallel.tiled_fill(z, mesh, nodata=-9999.0),
    }


def halo_path(fl, tp, z, elev, d8, upa, refs, dev):
    """The halo runtime (``parallel.tiled_*``) on the 6000x6000 grid, on
    this process's one-rank NCCL group: one block of 6000 x 6000 cells.
    ``tp`` is the grid's tile plan, ``z`` its DEM, ``elev`` the host flood,
    ``upa`` the upstream area in cells and ``refs`` the downward path's
    maps: ``stream_distance()``, ``basins()``,
    ``hand()`` with its drains, and the native sweep of the metric steps. Each call timed (host clock, synchronised) with the
    launch counters zeroed before it and read after; F1 held against its
    plain version on the framed buffer first. Returns the F1 rows (launches
    those of ``tiled_fill``), the timings, and the results where the machine
    has more cards (the multi-card ranks are held to them), else None."""
    import torch.distributed as dist

    from pyflwdir_torch import kernels, parallel
    from pyflwdir_torch.ops import fill as tfill
    from pyflwdir_torch.parallel import tiled

    print(" halo path (one rank):")
    t_path = time.perf_counter()
    mesh = parallel.make_mesh()
    _check(mesh.size == 1 and dist.get_backend(mesh.group) == "nccl",
           f"a mesh of the one rank of the NCCL group: {mesh}")
    H, W = TILE_SHAPE
    mask = fl.mask.reshape(TILE_SHAPE)
    n_valid = int(mask.sum())

    print(" kernel phase, F1 on the framed block:")
    dem_t, seeds, bad = tfill.fill_setup(z, nodata=-9999.0, device=dev)
    # the first round's frame as tiled_fill lays it out: +inf and fixed
    # around the block, rows padded to a multiple of 16 columns
    pads = (1, -(-(W + 2) // 16) * 16 - W - 1, 1, 1)
    pad = torch.nn.functional.pad
    rows = fill_kernel_phase(pad(dem_t, pads, value=float("inf")), pad(seeds, pads, value=False),
                             pad(bad, pads, value=True), True, 0, ".halo")
    del dem_t, seeds, bad

    print(" main path, halo:")
    wts = np.random.RandomState(HALO_SEED).rand(H, W).astype(np.float32)
    drain = refs["drain"]
    calls = _halo_calls(d8, z, elev, drain, wts, fl.idxs_pit, fl.transform, mesh)
    plain_calls = []
    plain = kernels.fill_sweep_plain

    def counted_plain(*args):
        plain_calls.append(args[0].device.type)
        return plain(*args)

    times, counts, rounds, res = {}, {}, {}, {}
    kernels.fill_sweep_plain = counted_plain
    try:
        for name, fn in calls.items():
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = fn()
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            counts[name] = {k: v for k, v in kernels.launches.items() if v}
            rounds[name] = dict(tiled.last_rounds)
            print(f"  {name}: {times[name]:.3f} s; launches {counts[name]}")
        again = parallel.tiled_accumulate(d8, wts, mesh)
    finally:
        kernels.fill_sweep_plain = plain

    t0 = time.perf_counter()
    acc_rtol, dist_rtol = _halo_rules(n_valid)
    want = upa.astype(np.float32)
    for name in ("tiled_accumulate_coarse", "tiled_accumulate_iterate"):
        got = res[name]
        _check(got.dtype == np.float32 and got.shape == TILE_SHAPE
               and np.array_equal(got[mask], want[mask]),
               f"{name} on unit weights bitwise the tile plan's int32 upstream_area() cast to "
               "float32 on the valid cells")
    _check(rounds["tiled_accumulate_iterate"]["accumulate"] == 0,
           "one rank: no halo round in flight for iterate")
    ref = tp.accumulate(torch.as_tensor(wts.ravel().astype(np.float64), device=dev))
    ref = ref.cpu().numpy().reshape(TILE_SHAPE)[mask]
    got = res["tiled_accumulate_weights"][mask]
    # the tile plan's float64 sums are differences of prefix sums: off by up
    # to 2 L eps total, L its longest chain of additions (tile_path)
    length = 128 * 128 + 2 * _scan_len(tp.coarse.n_pad) + tp.E_pad
    atol = 2 * length * _EPS * float(wts[mask].sum(dtype=np.float64))
    excess = float((np.abs(got - ref) - acc_rtol * np.abs(ref)).max() / atol)
    _check(bool(np.all(np.abs(got - ref) <= acc_rtol * np.abs(ref) + atol)),
           f"tiled_accumulate(float32 weights) within rtol 2^-24 + 2 n eps64 = {acc_rtol:.3e}, "
           f"atol 2 L eps total = {atol:.3e} (L {length}) of the float64 tile plan accumulate "
           f"(max excess over the rtol {excess:.2e} of atol)")
    _check(np.array_equal(again, res["tiled_accumulate_weights"]),
           "two coarse calls on the weights give the same bits")
    _check(np.array_equal(res["tiled_rank"].ravel(), fl.rank.ravel()),
           "tiled_rank bitwise equal to graph.rank")
    _check(np.array_equal(res["tiled_basins"].ravel(), refs["basins"].ravel().astype(np.int64)),
           f"tiled_basins bitwise equal to basins() ({fl.idxs_pit.size} pits, ids 1..n)")
    _check(np.array_equal(res["tiled_stream_distance_cells"], refs["stream_distance"]),
           "tiled_stream_distance(real_length=False) bitwise equal to stream_distance()")
    want = refs["stream_distance_m_sweep"]  # float64 sums of the float32 steps
    got = res["tiled_stream_distance_m"].ravel()
    m = fl.mask
    err = float((np.abs(got[m] - want[m]) / np.maximum(want[m], 1e-300)).max())
    _check(got.dtype == np.float32 and bool(np.all(got[~m] == -9999.0))
           and bool(np.all(np.abs(got[m] - want[m]) <= dist_rtol * want[m])),
           f"tiled_stream_distance (m) within rtol (rounds + 1) 2^-24 = {dist_rtol:.3e} of the "
           f"float64 sweep of the same float32 steps (max rel err {err:.3e}), -9999 outside")
    hnd, got = refs["hand"], res["tiled_hand"]
    atol = 2.0 ** -23 * float(np.abs(elev[mask]).max())
    err = float(np.abs(got[mask] - hnd[mask]).max())
    _check(got.dtype == np.float64 and bool(np.all(got[~mask] == -9999.0))
           and err <= atol,
           f"tiled_hand within atol 2^-23 max|elev| = {atol:.3e} of hand() ({int(drain.sum())} "
           f"drains above {DRAIN_CELLS} cells; max |err| {err:.3e})")
    strord = fl.stream_order()
    levels = rounds["tiled_strahler"]["strahler"]
    _check(np.array_equal(res["tiled_strahler"], strord),
           f"tiled_strahler bitwise equal to stream_order() ({levels} levels, orders "
           f"1-{int(strord.max())})")
    fill_rounds = rounds["tiled_fill"]["fill"]
    got = res["tiled_fill"]
    valid = z != -9999.0
    _check(np.array_equal(got[valid].astype(np.float32), elev[valid].astype(np.float32))
           and bool(np.all(got[~valid] == -9999.0)),
           f"tiled_fill bitwise equal to the host priority flood cast to float32 ({fill_rounds} "
           "rounds), nodata outside")
    f1 = counts["tiled_fill"].get("fill_sweep", 0)
    _check(f1 == 2 * fill_rounds > 0 and not plain_calls,
           f"tiled_fill launched F1 {f1} times (twice a round) and no plain fill sweep ran "
           f"({plain_calls})")
    _check(all(not c for k, c in counts.items() if k != "tiled_fill"),
           "the other halo functions launched no hand-written kernel (plain PyTorch, as their "
           "JAX source is plain XLA)")
    print(f"  checks {time.perf_counter() - t0:.2f} s")

    unit = np.ones(TILE_SHAPE, np.float32)
    dev_ms = _device_ms(lambda: parallel.tiled_accumulate(d8, unit, mesh), reps=1, warm=0,
                        traces=1)
    print(f"  tiled_accumulate (coarse): {times['tiled_accumulate_coarse']:.3f} s wall, "
          f"device busy {dev_ms} ms of a call")
    t_path = time.perf_counter() - t_path
    print(f"  halo path {t_path:.1f} s")
    out = _rows(rows, {"fill_sweep": f1}, f"halo {H}x{W} tiled_fill, 1 rank", "float32")
    keep = None
    if torch.cuda.device_count() > 1:  # what the multi-card ranks are held to
        keep = dict(ref=res, z=z, elev=elev, drain=drain, idxs_pit=fl.idxs_pit,
                    acc_rtol=acc_rtol)
    return out, dict(times_s=times, launches=counts, fill_rounds=fill_rounds,
                     strahler_levels=levels, accumulate_device_ms=dev_ms, path_s=t_path,
                     acc_rtol=acc_rtol, dist_rtol=dist_rtol), keep


def _rows(rows, counts, path, dtype, G=1):
    """The kernels line's rows of ``rows``, their launches read from the
    main path's ``counts``: a tile kernel's cluster launches (``_g<G>``)
    for the rows of a plan of 128 G-row tiles."""
    out = []
    for key, row in rows.items():
        kern = key.split(".")[0]
        if kern in _FILL_KERNELS:
            (tag, replaces), src = _FILL_KERNELS[kern], _FILL_SRC
        elif kern in _KERNELS:
            tag, src, replaces = _KERNELS[kern]
            if ".coarse_down" in key:
                replaces = (_BIG_DOWN if ".cut" in key else _COARSE_DOWN)[kern]
            elif ".coarse" in key:
                replaces = (_BIG if ".cut" in key else _COARSE)[kern]
            elif ".big" in key:
                replaces = _BIG[kern]
        elif ".shard" in key:
            (tag, replaces), src = _SHARD[kern], _TILE_SRC
        else:
            tag, replaces = {**_TILE_KERNELS, **_DOWN_KERNELS}[kern]
            if isinstance(replaces, dict):
                replaces = replaces[key.split(".")[1]]
            src = _TILE_SRC
        launches = counts[kern if G == 1 or kern in _KERNELS else f"{kern}_g{G}"]
        if ".coarse_down" in key:  # this call's share of the wrapper's count
            launches //= _COARSE_DOWN_CALLS[kern]
        out.append(dict(name=key, tag=tag, route="cuda", source=src, replaces=replaces,
                        launches=launches, path=path, dtype=dtype, **row))
    return out


def rhine_path(dev):
    """The 997x682 path through AccelPlan; returns its kernel rows and
    timings."""
    import pyflwdir_torch
    from pyflwdir_torch import kernels, runtime
    from pyflwdir_torch.ops import graph
    from pyflwdir_torch.ops.accel import AccelPlan

    print("rhine path (997x682):")
    t0 = time.perf_counter()
    elev, d8 = pyflwdir_torch.fill_depressions(_demo_dem(SHAPE, SEED))
    fl = pyflwdir_torch.from_array(d8, transform=LATLON, latlon=True)
    plan = fl._accel()
    print(f"  setup: fill + parse + plans {time.perf_counter() - t0:.2f} s; "
          f"{fl.size} cells, n_pad {plan.n_pad}, G {plan.G}, b {plan.b}")
    _check(isinstance(plan, AccelPlan) and plan.has_far,
           "main path takes the AccelPlan, with far intervals")

    print(" kernel phase:")
    rows = kernel_phase(plan, dev)

    print(" main path:")
    rng = np.random.RandomState(SEED + 1)
    fdata = rng.rand(*SHAPE).astype(np.float64)
    kernels.reset_launches()
    t0 = time.perf_counter()
    upa = fl.upstream_area()
    upa_km2 = fl.upstream_area("km2")
    acc = fl.accuflux(fdata)
    rnk = fl.rank
    roots = graph.roots(fl._ds).cpu().numpy()
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    counts = dict(kernels.launches)
    print(f"  main path {t_main:.3f} s; launches {counts}")
    for name in _UP:
        _check(counts[name] > 0, f"{name} launched on the main path")
    _check(counts["permute_gather"] == 0, "no permute_gather (H0) on the upward sweeps")

    mask = fl.mask.reshape(SHAPE)
    rk = rnk.ravel()
    seq = np.argsort(rk, kind="stable")
    seq = seq[rk[seq] >= 0]
    oracle = runtime.accuflux_sweep(fl.idxs_ds, seq, np.ones(fl.size)).reshape(SHAPE)
    _check(upa.dtype == np.int32 and upa.shape == SHAPE, "upstream_area() int32 of the grid's shape")
    _check(np.array_equal(upa[mask], oracle[mask].astype(np.int32)),
           "upstream_area() bitwise equal to the native sequential sweep")
    _check(int(upa.ravel()[fl.idxs_pit].sum()) == int(mask.sum()),
           "mass conservation: pit sums equal the valid count")
    _check(bool(np.all(upa[~mask] == -9999)), "-9999 outside the mask")
    _check(bool(np.isfinite(upa_km2).all()) and bool(np.isfinite(acc).all()),
           "km2 area and accuflux finite")

    cpu = pyflwdir_torch.from_array(d8, transform=LATLON, latlon=True, device="cpu")
    _check(np.array_equal(upa, cpu.upstream_area()), "upstream_area() equal to the CPU run")
    # float data takes the DFS plan: one prefix sum over every cell
    km2_cpu = cpu.upstream_area("km2")
    total = float(km2_cpu.ravel()[fl.idxs_pit].sum())
    _close(upa_km2, km2_cpu, fl.size, total, "upstream_area('km2') of the CPU run")
    _close(acc, cpu.accuflux(fdata), fl.size, float(fdata.sum()),
           "accuflux(float64) of the CPU run")
    _check(np.array_equal(rnk, cpu.rank), "rank equal to the CPU run")
    roots_cpu = graph.roots(cpu._ds).numpy()
    _check(np.array_equal(roots, roots_cpu), "roots equal to the CPU run")

    ones = torch.ones(fl.size, dtype=torch.int32, device=dev)
    acc_ms = _time_ms(lambda: fl._accumulate_dev(ones), reps=100, warmup=10)
    acc_dev_ms = _device_ms(lambda: fl._accumulate_dev(ones))
    up_ms = _host_ms(fl.upstream_area, 10)
    print(f"  accumulate: median {acc_ms:.4f} ms per call, "
          f"{fl.size / acc_ms / 1e3:.1f} Mgp/s; device busy {acc_dev_ms} ms of it; "
          f"upstream_area() with host copies median {up_ms:.3f} ms")
    # Pfafstetter sub-basins: host stem walks over maps made on the card (the
    # CPU tests hold them to the JAX package's; a CPU run here would double
    # the walks' half minute)
    t0 = time.perf_counter()
    pfaf, pf_out = fl.subbasins_pfafstetter(depth=2)
    pfaf_s = time.perf_counter() - t0
    pf = pfaf.ravel()
    inner = (rk >= 0) & ~np.isin(np.arange(fl.size), pf_out)
    _check(pfaf.dtype == np.int32 and bool((pf[rk >= 0] >= 1).all()) and int(pf.max()) < 100
           and np.unique(pf_out).size == pf_out.size
           and np.array_equal(pf[fl.idxs_ds[inner]], pf[inner]),
           f"subbasins_pfafstetter(depth=2) in {pfaf_s:.3f} s: {pf_out.size} outlets, labels "
           "1-99 on every valid cell, basins closed")
    surface = rhine_surface(fl, upa, elev)
    out = _rows(rows, counts, "rhine 997x682", "float32")
    return out, dict(accumulate_ms=acc_ms, accumulate_device_ms=acc_dev_ms,
                     upstream_area_ms=up_ms, main_path_s=t_main, pfafstetter_s=pfaf_s,
                     surface=surface)


def rhine_surface(fl, upa, elev):
    """The object surface at the Rhine size on the raster ``fl`` (``upa``:
    its upstream area in cells, ``elev`` its filled DEM): vectorize,
    spread2d and region_dissolve of its basins, dump and load, and the
    gradually-varied-flow river depth (host RK4 over the rank levels, too
    slow for the 6000x6000 tile); each timed (host clock, synchronised)
    and checked. Returns the timings."""
    import pyflwdir_torch

    print(" surface (Rhine size):")
    times = {}
    valid = fl.mask
    feats = _timed(times, "vectorize", fl.vectorize)
    heads = np.flatnonzero(valid)
    xs, ys = fl.xy(heads[::997])
    xd, yd = fl.xy(fl.idxs_ds[heads[::997]])
    sample = feats[::997]
    _check(len(feats) == heads.size and all(
        f["geometry"]["coordinates"] == [(a, b), (c, d)]
        for f, a, b, c, d in zip(sample, xs, ys, xd, yd)),
        f"vectorize(): {len(feats)} features, one a valid cell, from the cell to its "
        "downstream cell")
    del feats
    bas = _timed(times, "basins", fl.basins)
    lbs, size = np.unique(bas[bas > 0], return_counts=True)
    small = lbs[size < 50]
    keep = np.where(np.isin(bas, small), 0, bas)
    out, src, dst = _timed(times, "spread2d", lambda: pyflwdir_torch.spread2d(
        keep, nodata=0, latlon=True, transform=fl.transform))
    _check(bool(np.all(out.ravel() == keep.ravel()[src.ravel()])) and bool(np.all(dst >= 0))
           and bool(np.all(out[keep > 0] == keep[keep > 0])),
           "spread2d: every cell takes the value of its source cell, sources keep theirs")
    dis = _timed(times, "region_dissolve", lambda: pyflwdir_torch.regions.region_dissolve(
        bas, labels=small, latlon=True, transform=fl.transform))
    _check(not np.isin(dis, small).any() and np.array_equal(dis[keep > 0], bas[keep > 0])
           and bool(np.all(np.isin(dis[np.isin(bas, small)], lbs[size >= 50]))),
           f"region_dissolve: {small.size} basins under 50 cells dissolved into the "
           f"{lbs.size - small.size} others, the others unchanged")
    tmp = tempfile.mkdtemp(prefix="_plan_tmp", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        fn = os.path.join(tmp, "flw.pkl")
        _timed(times, "dump", lambda: fl.dump(fn))
        fl2 = _timed(times, "load", lambda: pyflwdir_torch.FlwdirRaster.load(fn))
        _check(fl2.device.type == "cuda" and np.array_equal(fl2.idxs_ds, fl.idxs_ds)
               and tuple(fl2.transform) == tuple(fl.transform)
               and np.array_equal(fl2.upstream_area(), upa),
               "dump / load: the same raster on the card, upstream_area() bitwise equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rng = np.random.RandomState(SEED + 8)
    q = rng.rand(*SHAPE) * 1000 + 1
    w = rng.rand(*SHAPE) * 100 + 10
    man = fl.river_depth(q, w, zs=elev, rivdst=fl.distnc)
    gvf = _timed(times, "river_depth_gvf", lambda: fl.river_depth(
        q, w, zs=elev, rivdst=fl.distnc, method="gvf"))
    mask = fl.mask.reshape(SHAPE)
    _check(bool(np.all(np.isfinite(gvf[mask]) & (gvf[mask] >= 1)))
           and bool(np.all(gvf[~mask] == -9999.0)),
           f"river_depth(method='gvf'): finite and >= 1 m on valid cells, -9999 elsewhere; "
           f"{int((gvf[mask] != man[mask]).sum())} of {int(mask.sum())} cells moved from "
           f"Manning's depth")
    return times


def _host_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def tile_path(dev):
    """The 6000x6000 path through TilePlan; returns its kernel rows, its DEM,
    host-filled surface and D8, and timings."""
    import pyflwdir_torch
    from pyflwdir_torch import kernels, runtime
    from pyflwdir_torch.ops.tile_plan import TilePlan, _CoarseRouterSmall

    print(f"tile path ({TILE_SHAPE[0]}x{TILE_SHAPE[1]}):")
    H, W = TILE_SHAPE
    t0 = time.perf_counter()
    z = _demo_dem(TILE_SHAPE, SEED)
    # a sea of nodata in the low corner: a coast of outlets, missing cells
    sea = np.add.outer(np.linspace(0, 1, H) ** 2, np.linspace(0, 1, W) ** 2) > 1.6
    z[sea] = -9999.0
    elev, d8 = pyflwdir_torch.fill_depressions(z, nodata=-9999.0)
    d8[sea] = 247
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    fl = pyflwdir_torch.from_array(d8, transform=TILE_LATLON, latlon=True)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp = fl._tile_plan()
    t_plan = time.perf_counter() - t0
    steps = ", ".join(f"{k} {v:.2f}" for k, v in tp.build_seconds.items())
    print(f"  setup: fill {t_fill:.2f} s, parse {t_parse:.2f} s, tile plan {t_plan:.2f} s "
          f"({steps})")
    co = tp.coarse
    print(f"  {fl.size} cells, {int(fl.mask.sum())} valid; NT {tp.NT}, R_pad {tp.R_pad}, "
          f"E_pad {tp.E_pad}, far_mode {tp.far_mode}, b {tp.b}; coarse "
          f"{type(co).__name__} n_pad {getattr(co, 'n_pad', None)}, "
          f"{tp._coarse_meta['m']} roots + {tp._coarse_meta['D']} entry nodes")
    _check(fl.size > fl._TILE_PLAN_MIN and isinstance(tp, TilePlan)
           and isinstance(co, _CoarseRouterSmall) and tp.far_mode == "router",
           "main path takes the TilePlan, with a _CoarseRouterSmall coarse level and "
           "far_mode 'router'")

    rows = {}
    for dtype in (torch.int32, torch.float64):
        print(f" kernel phase ({_DT[dtype]}):")
        rows[dtype] = tile_kernel_phase(tp, dtype, dev)

    print(" main path:")
    rng = np.random.RandomState(SEED + 1)
    fdata = rng.rand(H, W)
    kernels.reset_launches()
    t0 = time.perf_counter()
    upa = fl.upstream_area()
    torch.cuda.synchronize()
    t_int = time.perf_counter() - t0
    counts_int = dict(kernels.launches)
    kernels.reset_launches()
    t0 = time.perf_counter()
    upa_km2 = fl.upstream_area("km2")
    acc = fl.accuflux(fdata)
    torch.cuda.synchronize()
    t_f64 = time.perf_counter() - t0
    counts_f64 = dict(kernels.launches)
    print(f"  int32 {t_int:.3f} s; launches {counts_int}")
    print(f"  float64 {t_f64:.3f} s; launches {counts_f64}")
    for name in ("tile_pass_a", "tile_pass_c", *_UP):
        _check(counts_int[name] > 0 and counts_f64[name] > 0,
               f"{name} launched on the main path (int32 and float64)")
    _check(counts_int["permute_gather"] == counts_f64["permute_gather"] == 0,
           "no permute_gather (H0) on the upward sweeps")

    t0 = time.perf_counter()
    mask = fl.mask.reshape(TILE_SHAPE)
    seq = runtime.dfs_preorder(fl.idxs_ds)[0]  # downstream before upstream
    oracle = runtime.accuflux_sweep(fl.idxs_ds, seq, np.ones(fl.size)).reshape(TILE_SHAPE)
    _check(upa.dtype == np.int32 and upa.shape == TILE_SHAPE,
           "upstream_area() int32 of the grid's shape")
    _check(np.array_equal(upa[mask], oracle[mask].astype(np.int32)),
           "upstream_area() bitwise equal to the native sequential sweep")
    _check(int(upa.ravel()[fl.idxs_pit].sum()) == int(mask.sum()),
           "mass conservation: pit sums equal the valid count")
    _check(bool((~mask).any()) and bool(np.all(upa[~mask] == -9999)),
           "-9999 outside the mask")
    # a value sums a tile's prefix (T slots), the coarse level's prefix and
    # its tile's entry scan (E_pad), in another order than the sweep
    length = 128 * 128 + 2 * _scan_len(co.n_pad) + tp.E_pad
    area = np.asarray(fl.area).ravel() / 1e6
    want = runtime.accuflux_sweep(fl.idxs_ds, seq, area).reshape(TILE_SHAPE)
    _check(upa_km2.dtype == acc.dtype == np.float64, "km2 area and accuflux float64")
    _close(upa_km2[mask], want[mask], length, float(area[fl.mask.ravel()].sum()),
           "upstream_area('km2') of the native sweep")
    want = runtime.accuflux_sweep(fl.idxs_ds, seq, fdata.ravel()).reshape(TILE_SHAPE)
    _close(acc, want, length, float(fdata.sum()), "accuflux(float64) of the native sweep")
    print(f"  checks {time.perf_counter() - t0:.2f} s")

    ones = torch.ones(fl.size, dtype=torch.int32, device=dev)
    acc_ms = _time_ms(lambda: fl._accumulate_dev(ones), reps=20, warmup=3)
    acc_dev_ms = _device_ms(lambda: fl._accumulate_dev(ones))
    up_ms = _host_ms(fl.upstream_area, 5)
    print(f"  accumulate: median {acc_ms:.4f} ms per call, "
          f"{fl.size / acc_ms / 1e3:.1f} Mgp/s; device busy {acc_dev_ms} ms of it; "
          f"upstream_area() with host copies median {up_ms:.3f} ms")
    out = _rows(rows[torch.int32], counts_int, "tile 6000x6000", "int32")
    out += _rows(rows[torch.float64], counts_f64, "tile 6000x6000", "float64")
    order_rows, order = order_path(fl, tp, seq, rows[torch.int32], dev)
    out += order_rows
    down_rows, down, refs = tile_down_path(fl, tp, elev, upa, seq, dev)
    surface_rows, surface = surface_path(fl, tp, d8, upa, dev)
    upscale = upscale_path(fl, z, elev, upa, refs["hand"], seq, dev)
    banded_rows, banded = banded_path(
        fl, tp, upa, seq, dict(tile_plan_s=t_plan, down_indices_s=down["down_indices_s"]), dev)
    sharded_rows, sharded = sharded_path(fl, d8, seq, dev)
    tall_rows, tall = tall_path(fl, tp, d8, upa, seq, refs, dev)
    halo_rows, halo, halo_res = halo_path(fl, tp, z, elev, d8, upa, refs, dev)
    del refs
    big_rows, big = big_path(fl, upa, seq, dict(ms=acc_ms, device_ms=acc_dev_ms), dev)
    cut_rows, cut = cut_path(fl, elev, upa, dev)
    rows = (out + down_rows + surface_rows + banded_rows + sharded_rows + tall_rows + halo_rows
            + big_rows + cut_rows)
    return rows, (z, elev, d8, halo_res), dict(
        order=order, down=down, surface=surface, upscale=upscale, banded=banded, sharded=sharded,
        tall=tall, halo=halo, big=big, cut=cut,
        accumulate_ms=acc_ms, accumulate_device_ms=acc_dev_ms, upstream_area_ms=up_ms,
        main_path_int32_s=t_int, main_path_float64_s=t_f64, fill_s=t_fill, parse_s=t_parse,
        tile_plan_s=t_plan, tile_plan_steps_s=tp.build_seconds, NT=tp.NT, R_pad=tp.R_pad,
        E_pad=tp.E_pad, coarse_n_pad=co.n_pad)


def order_path(fl, tp, seq, rows_int, dev):
    """Stream order, the nodata accumulations and sub-basins on the
    6000x6000 grid ``fl`` with its tile plan ``tp`` (``seq``: the native DFS
    preorder). The Strahler call is driven with the launch counters zeroed
    before it and read after: T1, T2 and the coarse H1-H3 once a level.
    Returns the order path's kernel rows (the int32 phase's measurements,
    ``rows_int``, with this path's launches) and its timings."""
    from pyflwdir_torch import kernels, runtime
    from pyflwdir_torch.codecs import d8 as d8c
    from pyflwdir_torch.ops import graph, order

    print(" order phase (stream order, nodata accumulations, sub-basins):")
    H, W = fl.shape
    n = fl.size
    valid = fl.mask
    res = {}
    t0 = time.perf_counter()
    want = runtime.strahler_order(fl.idxs_ds, seq)
    res["native_strahler_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes_host = d8c.to_array(fl.idxs_ds, fl.shape)
    res["host_d8_codes_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = order.d8_codes(fl._ds, fl.shape)
    torch.cuda.synchronize()
    res["device_d8_codes_s"] = time.perf_counter() - t0
    _check(np.array_equal(codes.cpu().numpy(), codes_host),
           "D8 codes made on the device equal to codecs.d8.to_array on the host")
    del codes_host

    for key in ("strord", "d8_codes"):
        fl._cached.pop(key, None)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strord = fl.stream_order()
    torch.cuda.synchronize()
    res["first_call_s"] = time.perf_counter() - t0
    counts = dict(kernels.launches)
    levels = int(strord.max()) - 1
    res.update(levels=levels, max_order=int(strord.max()), launches=counts)
    print(f"  Strahler: {levels} levels (orders 1-{int(strord.max())}); launches {counts}")
    _check(strord.dtype == np.uint8 and strord.shape == fl.shape
           and np.array_equal(strord.ravel(), want),
           "stream_order() bitwise equal to the native Strahler sweep")
    for name in ("tile_pass_a", "tile_pass_c", *_UP):
        _check(counts[name] == levels, f"{name} launched once per level ({levels})")
    _check(counts["permute_gather"] == 0 and counts["tile_down_a"] == 0,
           "no downward kernel on the Strahler path")
    fl._cached.pop("strord")
    t0 = time.perf_counter()
    strord2 = fl.stream_order()
    torch.cuda.synchronize()
    res["second_call_s"] = time.perf_counter() - t0
    _check(np.array_equal(strord2, strord), "a second uncached stream_order() the same")
    codes = fl._cached["d8_codes"]
    res["device_ms"] = _device_ms(lambda: order.strahler_tile_plan(codes, tp), reps=4, warm=1)
    member, tgt = order._strahler_grids(codes, tp, None)
    gen = order._generators(member, tgt).to(torch.int32)  # the first level's
    res["level_count_ms"] = _time_ms(lambda: order._generators(member, tgt), reps=10, warmup=2)
    res["level_accumulate_ms"] = _time_ms(lambda: tp.accumulate(gen), reps=10, warmup=2)
    print(f"  Strahler wall: first call {res['first_call_s'] * 1e3:.1f} ms, second uncached "
          f"{res['second_call_s'] * 1e3:.1f} ms (host clock, synchronised); device "
          f"{res['device_ms']} ms; a level: child count {res['level_count_ms']:.4f} ms, "
          f"accumulate {res['level_accumulate_ms']:.4f} ms (CUDA events); native sweep "
          f"{res['native_strahler_s']:.3f} s; D8 codes on the host "
          f"{res['host_d8_codes_s']:.3f} s, on the device {res['device_d8_codes_s']:.4f} s")

    t0 = time.perf_counter()
    usm = fl.idxs_us_main
    res["main_upstream_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    classic = fl.stream_order("classic")
    torch.cuda.synchronize()
    res["classic_s"] = time.perf_counter() - t0
    nup = fl.n_upstream.ravel()
    t0 = time.perf_counter()
    want = runtime.classic_order(fl.idxs_ds, seq, usm, nup)
    res["native_classic_s"] = time.perf_counter() - t0
    _check(np.array_equal(classic.ravel(), want), "classic stream order bitwise equal to the "
           "native sweep")
    print(f"  main_upstream {res['main_upstream_s']:.3f} s; classic order "
          f"{res['classic_s']:.3f} s, native {res['native_classic_s']:.3f} s")

    rng = np.random.RandomState(SEED + 3)
    nod = (rng.rand(H, W) < 0.02).ravel() & valid
    data = rng.randint(0, 5, n).astype(np.int32)
    data[nod] = -9999
    t0 = time.perf_counter()
    got = fl.accuflux(data.reshape(H, W)).ravel()
    res["accuflux_nodata_int32_s"] = time.perf_counter() - t0
    # the oracle: the graph cut at the nodata cells, which become pits of data 0
    ar = np.arange(n, dtype=np.int64)
    ids_cut = np.where(nod, ar, fl.idxs_ds)
    seq_cut = runtime.dfs_preorder(ids_cut)[0]
    acc = runtime.accuflux_sweep(ids_cut, seq_cut, np.where(nod, 0, data))
    _check(got.dtype == np.int32 and np.array_equal(got, np.where(valid & ~nod, acc, data)),
           "int32 accuflux with nodata bitwise equal to the native sweep on the cut graph")
    fdata = rng.rand(n)
    fdata[nod] = -9999.0
    t0 = time.perf_counter()
    fa = fl.accuflux(fdata.reshape(H, W)).ravel()
    res["accuflux_nodata_float64_s"] = time.perf_counter() - t0
    fb = fl.accuflux(fdata.reshape(H, W)).ravel()
    _check(np.array_equal(fa.view(np.int64), fb.view(np.int64)),
           "float64 accuflux with nodata: two calls, the same bits")
    acc = runtime.accuflux_sweep(ids_cut, seq_cut, np.where(nod, 0.0, fdata))
    # each doubling round adds its terms in another order than the sweep
    length = graph._n_rounds(n) * int(nup.max())
    _close(fa, np.where(valid & ~nod, acc, fdata), length, float(np.abs(fdata[~nod]).sum()),
           "float64 accuflux with nodata of the native sweep on the cut graph")
    print(f"  accuflux with nodata: int32 {res['accuflux_nodata_int32_s']:.3f} s, float64 "
          f"{res['accuflux_nodata_float64_s']:.3f} s")

    gaps = np.where(rng.rand(n) < 0.3, -9999.0, rng.rand(n)).reshape(H, W)
    for how in ("max", "sum"):
        t0 = time.perf_counter()
        a = fl.fillnodata(gaps, -9999.0, direction="down", how=how)
        res[f"fillnodata_down_{how}_s"] = time.perf_counter() - t0
        b = fl.fillnodata(gaps, -9999.0, direction="down", how=how)
        _check(np.array_equal(a.view(np.int64), b.view(np.int64))
               and bool((a[gaps != -9999.0] == gaps[gaps != -9999.0]).all()),
               f'fillnodata(direction="down", how="{how}"): two calls, the same bits; '
               "valid cells kept")
    print(f"  fillnodata down: max {res['fillnodata_down_max_s']:.3f} s, sum "
          f"{res['fillnodata_down_sum_s']:.3f} s")

    t0 = time.perf_counter()
    sb, outl = fl.subbasins_streamorder()
    res["subbasins_streamorder_s"] = time.perf_counter() - t0
    sbf = sb.ravel()
    inner = (sbf > 0) & ~np.isin(ar, outl)
    _check(sb.dtype == np.int32 and sb.max() == outl.size
           and np.array_equal(sbf[outl], np.arange(1, outl.size + 1))
           and np.array_equal(sbf[fl.idxs_ds[inner]], sbf[inner]),
           f"subbasins_streamorder(): {outl.size} outlets, each its own basin's id, "
           "basins closed")
    t0 = time.perf_counter()
    sa, outa = fl.subbasins_area(100.0)
    res["subbasins_area_s"] = time.perf_counter() - t0
    saf = sa.ravel()
    _check(sa.dtype == np.uint32 and outa.size >= fl.idxs_pit.size
           and np.array_equal(saf[outa], np.arange(1, outa.size + 1))
           and int((saf > 0).sum()) == fl.nnodes,
           f"subbasins_area(100 km2): {outa.size} outlets, each its own id, every valid "
           "cell in a sub-basin")
    res.update(subbasins_streamorder_outlets=int(outl.size),
               subbasins_area_outlets=int(outa.size))
    print(f"  subbasins_streamorder {res['subbasins_streamorder_s']:.3f} s, subbasins_area "
          f"{res['subbasins_area_s']:.3f} s")
    return _rows(rows_int, counts, "strahler 6000x6000", "int32"), res


SNAP_SEEDS = 100_000  # cells snapped to the streams of the surface phase
STREAM_CELLS = 1_000  # streams: cells draining at least this many cells
PATH_HEADS = 1_000  # headwaters whose paths the surface phase walks
WINDOW_N = 5  # the moving windows' half width
ORACLE_CELLS = 100_000  # cells the moving windows are held to a numpy oracle at


def _window_np(ids, usm, n, cells, strord=None):
    """The walk's window of ``cells`` on the host: row n the cells, rows n+1..2n
    the steps downstream (stopping before a higher stream order than the
    cell's own, with ``strord``), rows n-1..0 the steps up the main upstream
    cells; -1 where absent."""
    ar = np.arange(ids.size)
    ds = np.where(ids < 0, ar, ids)
    win = np.full((2 * n + 1, cells.size), -1, dtype=np.int64)
    win[n] = cells
    cur, stopped = cells.copy(), ids[cells] < 0
    for k in range(1, n + 1):
        nxt = ds[np.maximum(cur, 0)]
        stop = (nxt == cur) | (cur < 0)
        if strord is not None:
            stop |= strord[np.maximum(nxt, 0)] > strord[cells]
        stopped |= stop
        cur = np.where(stopped, -1, nxt)
        win[n + k] = cur
    cur, stopped = cells.copy(), ids[cells] < 0
    for k in range(1, n + 1):
        nxt = np.where(cur >= 0, usm[np.maximum(cur, 0)], -1)
        stopped |= nxt < 0
        cur = np.where(stopped, -1, nxt)
        win[n - k] = cur
    return win


def _label_extents_np(regions):
    """The label extents of the JAX package's ``regions._label_extents``, in
    numpy (ufunc ``at`` reductions on the host)."""
    nrow, ncol = regions.shape
    flat = regions.ravel()
    cells = np.nonzero(flat > 0)[0]
    lbs, inv = np.unique(flat[cells], return_inverse=True)
    rows, cols = cells // ncol, cells % ncol
    k = lbs.size
    rmin, cmin = np.full(k, nrow, np.int64), np.full(k, ncol, np.int64)
    rmax, cmax = np.full(k, -1, np.int64), np.full(k, -1, np.int64)
    np.minimum.at(rmin, inv, rows)
    np.maximum.at(rmax, inv, rows)
    np.minimum.at(cmin, inv, cols)
    np.maximum.at(cmax, inv, cols)
    return lbs, rmin, rmax, cmin, cmax


def _bounds_np(regions, transform):
    """The JAX package's ``regions.region_bounds``, in numpy."""
    lbs, rmin, rmax, cmin, cmax = _label_extents_np(regions)
    xres, yres, xoff, yoff = transform[0], transform[4], transform[2], transform[5]
    xa, xb = xoff + cmin * xres, xoff + (cmax + 1) * xres
    ya, yb = yoff + rmin * yres, yoff + (rmax + 1) * yres
    bboxs = np.stack([np.minimum(xa, xb), np.minimum(ya, yb), np.maximum(xa, xb),
                      np.maximum(ya, yb)], axis=1)
    return lbs, bboxs, np.hstack([bboxs[:, :2].min(axis=0), bboxs[:, 2:].max(axis=0)])


def _outlets_np(regions, ids):
    """The JAX package's ``regions.region_outlets``, in numpy."""
    lb = regions.ravel()
    ar = np.arange(ids.size)
    ds = np.where(ids < 0, ar, ids)
    is_out = (ids >= 0) & (lb > 0) & ((ds == ar) | (lb[ds] != lb))
    out = np.flatnonzero(is_out)
    sort = np.argsort(lb[out], kind="stable")
    return lb[out][sort], out[sort]


def _timed(times, key, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[key] = time.perf_counter() - t0
    return out


def _launched(counts, names):
    return all(counts.get(k, 0) > 0 for k in names)


def surface_path(fl, tp, d8, upa, dev):
    """The object surface on the 6000x6000 raster ``fl`` and its plan ``tp``
    (``d8`` its codes, ``upa`` its upstream area in cells): snapping, paths,
    moving windows, upstream sums, the cell order, basin bounds and outlets,
    a checkpoint and stream features, each step timed (host clock,
    synchronised) and checked, with the launch counters zeroed before each
    group and read after. Returns the kernel rows of the downward sweep of
    basins(idxs=snapped), measured on its own cut plan, and the timings."""
    import pyflwdir_torch
    from pyflwdir_torch import checkpoint, kernels, runtime
    from pyflwdir_torch.ops import walk
    from pyflwdir_torch.utils import geodesy

    print(" surface phase (snapping, paths, moving windows, regions, checkpoint):")
    H, W = fl.shape
    n = fl.size
    ids, valid = fl.idxs_ds, fl.mask
    ar = np.arange(n, dtype=np.int64)
    rng = np.random.RandomState(SEED + 5)
    times, res = {}, {}
    up_kernels = ("tile_pass_a", "tile_pass_c", *_UP)
    down_kernels = ("tile_down_a", "tile_down_fin", "accel_in_scan", "permute_gather")

    # 1. snapping to streams, the basins of the snapped cells, add_pits
    stream = upa.ravel() >= STREAM_CELLS
    seeds = rng.choice(np.flatnonzero(valid), SNAP_SEEDS, replace=False)
    kernels.reset_launches()
    ends, lens = _timed(times, "snap", lambda: fl.snap(idxs=seeds, mask=stream))
    paths, _ = _timed(times, "snap_paths", lambda: fl.path(idxs=seeds, mask=stream))
    counts = dict(kernels.launches)
    pit = ids[ends] == ends
    before = np.concatenate([p[:-1] for p in paths])
    _check(ends.dtype == np.int64 and bool(np.all(stream[ends] | pit))
           and np.array_equal(ends, [p[-1] for p in paths])
           and np.array_equal(lens, [p.size - 1 for p in paths])
           and np.array_equal(ids[before], np.concatenate([p[1:] for p in paths]))
           and not stream[before].any(),
           f"snap(mask=streams): {SNAP_SEEDS} cells, each end a stream cell "
           f"({STREAM_CELLS} cells or more) or a pit, the last cell of its path(), which "
           f"follows the flow and meets no stream cell before it; "
           f"{int((~stream[seeds]).sum())} seeds moved, at most {int(lens.max())} steps")
    _check(not any(counts.values()), "snapping launched no kernel (host walks)")
    with _PlanBuilds() as builds:
        kernels.reset_launches()
        bas = _timed(times, "basins_snapped", lambda: fl.basins(idxs=ends))
        counts = dict(kernels.launches)
    w = np.zeros(n, np.int64)
    w[ends] = np.arange(1, ends.size + 1)
    flat = bas.ravel()
    inner = valid & (w == 0)
    _check(bas.dtype == np.uint32 and np.array_equal(flat[ends], w[ends])
           and np.array_equal(flat[inner], flat[ids[inner]])
           and bool(np.all(flat[fl.idxs_pit[w[fl.idxs_pit] == 0]] == 0))
           and bool(np.all(flat[~valid] == 0)),
           f"basins(idxs=ends): {np.unique(ends).size} outlets, each its own id, basins "
           "closed along the flow, 0 below the outlets and outside the mask")
    _check(counts.get("tile_down_a") == 1 and counts.get("tile_down_fin") == 1
           and _launched(counts, down_kernels)
           and not any(counts.get(k, 0) for k in ("tile_pass_a", "tile_pass_c",
                                                  "accel_near_out", "accel_far_merge")),
           f"basins(idxs=ends): one cut-graph downward sweep (T3, coarse H1 and H0, T4), "
           f"no upward kernel; launches {counts}; cut plan "
           f"{type(builds.plans[0].coarse).__name__}, built in {builds.seconds[0]:.2f} s")
    res["basins_cut_plan_s"] = builds.seconds[0]
    # the sweep's kernels against their plain versions on its own cut plan;
    # T3 runs in raw mode there
    snap_tp = builds.plans[0]
    coarse = type(snap_tp.coarse).__name__
    print(f" kernel phase, cut plan of basins(idxs=snapped) (int32; coarse {coarse}):")
    rows = tile_down_kernel_phase(snap_tp, torch.int32, dev,
                                  ".cut.snap" if coarse == "BigAccelPlan" else ".snap", ("raw",))
    krows = _rows(rows, counts, "surface basins(idxs=snapped) 6000x6000", "int32")
    del snap_tp, rows, builds

    cp = pyflwdir_torch.FlwdirRaster(ids.copy(), fl.shape, fl.ftype, transform=fl.transform,
                                     latlon=fl.latlon, device=dev)
    cp._cached.update(tile_plan=tp, ds=fl._ds, rank=fl.rank)  # state to be dropped
    _timed(times, "add_pits_streams", lambda: cp.add_pits(idxs=seeds, streams=stream))
    ids2 = ids.copy()
    ids2[ends] = ends
    _check(not cp._cached and np.array_equal(cp.idxs_ds, ids2)
           and np.array_equal(cp.idxs_pit, np.unique(np.concatenate([fl.idxs_pit, ends]))),
           "add_pits(streams=...): the snapped ends made pits, every cached state dropped")
    kernels.reset_launches()
    upa2 = _timed(times, "upstream_area_after_add_pits", cp.upstream_area)
    counts = dict(kernels.launches)
    seq2 = runtime.dfs_preorder(ids2)[0]
    want = runtime.accuflux_sweep(ids2, seq2, np.ones(n))
    _check(np.array_equal(upa2.ravel()[valid], want[valid].astype(np.int32))
           and cp._cached["tile_plan"] is not tp,
           "upstream_area() after add_pits on a new tile plan, bitwise equal to the native "
           "sweep of the new graph (what a fresh object gives)")
    _check(_launched(counts, up_kernels), f"... through T1, T2 and H1-H3; launches {counts}")
    del cp, upa2, want, seq2, bas, paths, before

    # 2. paths from headwaters, their lengths against distnc
    hw = np.flatnonzero(valid & (fl.n_upstream.ravel() == 0))
    heads = np.sort(rng.choice(hw, PATH_HEADS, replace=False))
    fl._cached.pop("distnc", None)
    kernels.reset_launches()
    distnc = _timed(times, "distnc", lambda: fl.distnc).ravel()
    counts = dict(kernels.launches)
    _check(counts.get("tile_down_a") == 1 and counts.get("tile_down_fin") == 1
           and _launched(counts, down_kernels), f"distnc: one downward sweep; launches {counts}")
    hpaths, hdist = _timed(times, "paths_m", lambda: fl.path(idxs=heads, unit="m"))
    last = np.array([p[-1] for p in hpaths])
    moving = (ids >= 0) & (ids != ar)
    w64 = _timed(times, "distance_grid_host", lambda: geodesy.distance_grid(
        ids, fl.shape, latlon=True, transform=fl.transform))  # what distnc computes first
    w32 = np.where(moving, w64, 0).astype(np.float32)
    del w64
    length = 2 * (128 * 128 + 2 * _scan_len(tp.coarse._down_t["es_in"].numel()))
    atol = 2 * length * _EPS * float(w32.sum(dtype=np.float64))
    err = float(np.abs(distnc[heads] - hdist).max())
    _check(bool(np.all(ids[last] == last)) and hdist.dtype == np.float64
           and np.allclose(distnc[heads], hdist, rtol=1e-6, atol=atol),
           f"path(unit='m') from {PATH_HEADS} headwaters: each ends at a pit, its length "
           f"distnc at its head (float32) within rtol 1e-6, atol 2 L eps total = {atol:.3e} "
           f"(max |err| {err:.3e} m of up to {float(hdist.max()):.0f} m)")
    del w32, hpaths

    # 3. moving windows, without and with the stream-order stop
    data = rng.rand(n).astype(np.float32) * 100
    data[rng.rand(n) < 0.05] = -9999.0
    data[~valid] = -9999.0
    _check("idxs_us_main" in fl._cached, "the main upstream cells cached (order phase)")
    strord = fl.stream_order().ravel()
    levels = int(strord.max()) - 1
    cells = np.sort(rng.choice(n, ORACLE_CELLS, replace=False))
    for restrict in (False, True):
        tag = "_strord" if restrict else ""
        got = {}
        for fn in ("moving_average", "moving_median"):
            fl._cached.pop("strord", None)
            kernels.reset_launches()
            got[fn] = _timed(times, fn + tag, lambda: getattr(fl, fn)(
                data, WINDOW_N, restrict_strord=restrict)).ravel()
            counts = dict(kernels.launches)
            if restrict:
                _check(all(counts.get(k, 0) == levels for k in up_kernels),
                       f"{fn}(restrict_strord=True): T1, T2 and the coarse H1-H3 once a "
                       f"Strahler level ({levels}); launches {counts}")
            else:
                _check(not any(counts.values()), f"{fn}: no kernel launched (torch ops)")
        win = _window_np(ids, fl.idxs_us_main, WINDOW_N, cells, strord if restrict else None)
        vals = data[np.maximum(win, 0)]
        ok = (win >= 0) & (vals != -9999.0)
        centre = data[cells] != -9999.0
        med = np.full(cells.size, -9999.0, np.float32)
        med[centre] = np.nanmedian(np.where(ok, vals, np.nan)[:, centre], axis=0)
        k = ok.sum(axis=0)
        _check(np.array_equal(got["moving_median"][cells], med),
               f"moving_median(n={WINDOW_N}{', restrict_strord' if restrict else ''}) bitwise "
               f"equal to np.nanmedian of the walk's windows at {ORACLE_CELLS} cells "
               f"({int((k[centre] % 2 == 0).sum())} with an even count)")
        mean = np.where(ok, vals, 0).astype(np.float64).sum(axis=0) / np.maximum(k, 1)
        tol = 2 * (2 * WINDOW_N + 1) * np.finfo(np.float32).eps * (
            np.abs(np.where(ok, vals, 0)).astype(np.float64).sum(axis=0) / np.maximum(k, 1))
        avg = got["moving_average"][cells]
        err = np.abs(avg.astype(np.float64) - mean)
        _check(bool(np.all(err[centre] <= tol[centre])) and bool(np.all(avg[~centre] == -9999.0)),
               f"moving_average(n={WINDOW_N}{', restrict_strord' if restrict else ''}) within "
               f"2 (2n+1) eps32 of the float64 window mean at {ORACLE_CELLS} cells "
               f"(float32 sums, as the JAX expression; max |err| / tol "
               f"{float((err[centre] / tol[centre]).max()):.2e})")
    del win, vals, ok, got

    # ... and on a 1024x1024 crop, the card against the port's CPU run
    crop = d8[:DEM_CROP, :DEM_CROP]
    fc = pyflwdir_torch.from_array(crop, transform=fl.transform, latlon=True, device=dev)
    fh = pyflwdir_torch.from_array(crop, transform=fl.transform, latlon=True, device="cpu")
    dcrop = data.reshape(H, W)[:DEM_CROP, :DEM_CROP]
    for restrict in (False, True):
        so_c = fc.stream_order().ravel() if restrict else None
        win_c = walk.window_indices(fc._ds, torch.as_tensor(fc.idxs_us_main, device=dev),
                                    WINDOW_N, None if so_c is None else
                                    torch.as_tensor(so_c, device=dev)).cpu()
        win_h = walk.window_indices(fh._ds, torch.as_tensor(fh.idxs_us_main), WINDOW_N,
                                    None if so_c is None else torch.as_tensor(so_c))
        a_c = fc.moving_average(dcrop, WINDOW_N, restrict_strord=restrict)
        a_h = fh.moving_average(dcrop, WINDOW_N, restrict_strord=restrict)
        m_c = fc.moving_median(dcrop, WINDOW_N, restrict_strord=restrict)
        m_h = fh.moving_median(dcrop, WINDOW_N, restrict_strord=restrict)
        tag = ", restrict_strord" if restrict else ""
        _check(torch.equal(win_c, win_h) and np.array_equal(m_c, m_h),
               f"1024x1024 crop{tag}: windows and medians of the card bitwise equal to the "
               "CPU run's")
        good = dcrop != -9999.0
        _check(np.allclose(a_c[good], a_h[good], rtol=2 * (2 * WINDOW_N + 1)
                           * np.finfo(np.float32).eps, atol=0)
               and np.array_equal(a_c[~good], a_h[~good]),
               f"1024x1024 crop{tag}: averages of the card within 2 (2n+1) eps32 of the "
               f"CPU run's (bitwise: {np.array_equal(a_c, a_h)})")
    del fc, fh

    # 4. upstream sums
    di = rng.randint(0, 1000, n).astype(np.int32)
    di[rng.rand(n) < 0.02] = -9999
    kernels.reset_launches()
    us = _timed(times, "upstream_sum_int32", lambda: fl.upstream_sum(di.reshape(H, W))).ravel()
    _check(not any(kernels.launches.values()), "upstream_sum: no kernel launched (torch ops)")
    ds = np.where(ids < 0, ar, ids)
    send = moving & (di != -9999) & (di[ds] != -9999)
    want = np.zeros(n, np.int32)
    np.add.at(want, ids[send], di[send])
    bad = moving & ((di == -9999) | (di[ds] == -9999))
    _check(us.dtype == np.int32 and np.array_equal(us, np.where(bad, -9999, want)),
           "upstream_sum(int32) bitwise equal to np.add.at")
    df = rng.rand(n)
    a = _timed(times, "upstream_sum_float64", lambda: fl.upstream_sum(df.reshape(H, W)))
    b = fl.upstream_sum(df.reshape(H, W))
    _check(a.dtype == np.float64 and np.array_equal(a.view(np.int64), b.view(np.int64)),
           "upstream_sum(float64): two calls, the same bits")
    del di, us, want, send, bad, df, a, b

    # 5. the cell order
    fl._seq = None
    seqc = _timed(times, "idxs_seq", lambda: fl.idxs_seq)
    rk = fl.rank.ravel()
    pos = np.full(n, -1, np.int64)
    pos[seqc] = np.arange(seqc.size)
    want = np.flatnonzero(rk >= 0)
    want = want[np.argsort(rk[want], kind="stable")]
    _check(np.array_equal(seqc, want) and bool(np.all(pos[ids[seqc]] <= pos[seqc])),
           f"idxs_seq: {seqc.size} cells, each after its downstream cell, equal to the host's "
           "stable argsort of rank")
    del pos, want, seqc

    # 6. basin bounds and outlets
    kernels.reset_launches()
    bas = _timed(times, "basins", fl.basins)
    lbs, bb, tot = _timed(times, "basin_bounds", lambda: fl.basin_bounds(basins=bas))
    lo, io = _timed(times, "basin_outlets", lambda: fl.basin_outlets(bas))
    wl, wb, wt = _bounds_np(bas, fl.transform)
    wlo, wio = _outlets_np(bas, ids)
    _check(np.array_equal(lbs, wl) and np.array_equal(bb, wb) and np.array_equal(tot, wt)
           and np.array_equal(lo, wlo) and np.array_equal(io, wio)
           and np.array_equal(np.sort(io), fl.idxs_pit[bas.ravel()[fl.idxs_pit] > 0]),
           f"basin_bounds() and basin_outlets() of basins() ({lbs.size} basins) bitwise "
           "equal to numpy copies of the JAX formulas; the outlets are the pits")
    del bas, lbs, bb

    # 7. a checkpoint round trip
    ck_dir = tempfile.mkdtemp(prefix="_plan_tmp", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        _timed(times, "checkpoint_save", lambda: checkpoint.save_sharded(fl, ck_dir))
        fl2, _ = _timed(times, "checkpoint_load", lambda: checkpoint.load_sharded(ck_dir))
        _check(fl2.device.type == "cuda" and np.array_equal(fl2.idxs_ds, ids),
               "load_sharded: the same graph, on the card")
        kernels.reset_launches()
        upa3 = _timed(times, "upstream_area_after_load", fl2.upstream_area)
        _check(np.array_equal(upa3, upa), "upstream_area() of the loaded raster bitwise "
               f"equal to the original's; launches {dict(kernels.launches)}")
        _check(_launched(dict(kernels.launches), up_kernels), "... through T1, T2 and H1-H3")
        del fl2, upa3
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)

    # 8. stream features
    feats = _timed(times, "streams_min_sto4", lambda: fl.streams(min_sto=4))
    _check(len(feats) > 0 and all(f["properties"]["strord"] >= 4 for f in feats[:1000]),
           f"streams(min_sto=4): {len(feats)} features")
    res["streams_min_sto4_features"] = len(feats)
    del feats
    res.update(times_s=times, levels=levels)
    return krows, res


UPSCALE_CELLSIZE = 10  # 3 arcsec to 30 arcsec: the 6000x6000 tile to 600x600
UPSCALE_CROP = 1200  # side of the crop upscaled on the card and on the CPU
MEDIAN_OUTLETS = 10_000  # outlets whose segment medians are held to np.nanmedian
FLOOD_KM2 = 1000  # floodplains: streams drain at least this many km2


def _round_odd_np(s, e):
    """numpy copy of ``dem._round_odd``."""
    bits = s.view(np.int64 if s.dtype == np.float64 else np.int32)
    step = np.nextafter(s, np.where(e > 0, np.inf, -np.inf).astype(s.dtype))
    return np.where((e != 0) & ((bits & 1) == 0), step, s)


def _hypot_np(x, y):
    """numpy copy of ``jnp.hypot`` as XLA's CPU code runs it (float64):
    ``max * sqrt(1 + (min / max)^2)``, the sum and square rounded once,
    as the fused multiply-add it contracts them into gives them."""
    x, y = np.abs(x), np.abs(y)
    inf = np.isposinf(x) | np.isposinf(y)
    hi, lo = np.maximum(x, y), np.minimum(x, y)
    zero = hi == 0
    r = lo / np.where(zero, 1.0, hi)
    uh = r * r
    c = r * 134217729.0
    rh = c - (c - r)
    rl = r - rh
    ul = ((rh * rh - uh) + (2 * rh) * rl) + rl * rl
    th = 1 + uh
    tl = (1 - th) + uh
    v = tl + ul
    vb = v - tl
    ev = (tl - (v - vb)) + (ul - vb)
    out = np.where(zero, hi, hi * np.sqrt(th + _round_odd_np(v, ev)))
    return np.where(inf, np.inf, out)


def _slope_np(z, nodata, transform):
    """numpy copy of the JAX package's ``dem.slope`` on a latlon grid of
    float64 elevations (``pyflwdir_tpu/dem.py:106-143``)."""
    from pyflwdir_torch.utils import geodesy

    nrow, ncol = z.shape
    bad = z == nodata
    pad = np.pad(z, 1, constant_values=nodata)
    pad_bad = np.pad(bad, 1, constant_values=True)

    def nb(dr, dc):
        v = pad[1 + dr : 1 + dr + nrow, 1 + dc : 1 + dc + ncol]
        b = pad_bad[1 + dr : 1 + dr + nrow, 1 + dc : 1 + dc + ncol]
        return np.where(b, z, v)

    xres, yres, north = transform[0], transform[4], transform[5]
    dzdx = ((nb(-1, -1) + 2 * nb(0, -1) + nb(1, -1))
            - (nb(-1, 1) + 2 * nb(0, 1) + nb(1, 1))) / (8 * abs(xres))
    dzdy = ((nb(-1, -1) + 2 * nb(-1, 0) + nb(-1, 1))
            - (nb(1, -1) + 2 * nb(1, 0) + nb(1, 1))) / (8 * abs(yres))
    lat = north + (np.arange(nrow) + 0.5) * yres
    slp = _hypot_np(dzdx / geodesy.degree_metres_x(lat)[:, None],
                    dzdy / geodesy.degree_metres_y(lat)[:, None])
    return np.where(bad, nodata, slp).astype(np.float32)


def _flood_np(ids, rank, z, stream):
    """For each cell, the first ``stream`` cell at or below it (else its
    pit) and the largest ``z`` on its path to it, that cell left out
    (-inf where the cell is it): a host sweep over the rank levels,
    downstream first."""
    n = ids.size
    t = np.arange(n)
    pathmax = np.full(n, -np.inf, np.float32)
    cells = np.flatnonzero(rank >= 1)
    cells = cells[np.argsort(rank[cells], kind="stable")]
    bounds = np.searchsorted(rank[cells], np.arange(1, int(rank.max(initial=0)) + 2))
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        c = cells[b0:b1]
        d = ids[c]
        to_stream = stream[d]
        t[c] = np.where(stream[c], c, np.where(to_stream, d, t[d]))
        pathmax[c] = np.where(stream[c], -np.inf,
                              np.where(to_stream, z[c], np.maximum(z[c], pathmax[d])))
    return t, pathmax


def _rule(got, want, labels, terms, eps, has):
    """Per unit catchment (outlets ``has``): |got - want| <= (k - 1) eps
    sum|term|, k its cell count. Returns (ok, largest |err| / limit)."""
    sel = labels > 0
    k = np.bincount(labels[sel] - 1, minlength=has.size)
    tot = np.bincount(labels[sel] - 1, weights=np.abs(terms[sel]), minlength=has.size)
    err = np.abs(got.astype(np.float64) - want)[has]
    lim = (np.maximum(k - 1, 0) * eps * tot)[has]
    return bool(np.all(err <= lim)), float(np.max(err / np.where(lim > 0, lim, 1.0), initial=0))


def upscale_path(fl, z, elev, upa, hnd, seq, dev):
    """Upscaling, unit catchments, sub-grid rivers, the rest of dem and the
    rivers on the 6000x6000 raster ``fl`` (``z`` its DEM, ``elev`` the host
    fill of it, ``upa`` its upstream area in cells, ``hnd`` the downward
    path's hand(), ``seq`` its cells downstream first), each step timed
    (host clock, synchronised) and checked, with the launch counters zeroed
    before each group and read after. The tile-plan kernels it reaches are
    held against their plain versions by the earlier phases: here their
    launches are checked. Returns the timings and counts."""
    import pyflwdir_torch
    from pyflwdir_torch import kernels, runtime, upscale

    cs = UPSCALE_CELLSIZE
    print(f" upscale phase (cellsize {cs}: upscaling, unit catchments, sub-grid rivers, "
          "DEM steps, rivers):")
    H, W = fl.shape
    n = fl.size
    ids, valid = fl.idxs_ds, fl.mask
    ar = np.arange(n, dtype=np.int64)
    dsl = np.where(ids < 0, ar, ids)
    pit = valid & (ids == ar)
    rng = np.random.RandomState(SEED + 7)
    times, res = {}, {}
    up_kernels = ("tile_pass_a", "tile_pass_c", *_UP)
    down_kernels = ("tile_down_a", "tile_down_fin", "accel_in_scan", "permute_gather")

    def launched_up(counts, what):
        _check(_launched(counts, up_kernels) and not counts.get("tile_down_a"),
               f"{what}: the derived upstream area through T1, T2 and the coarse H1-H3, no "
               f"downward kernel; launches {counts}")

    def launched_down(counts, what):
        _check(counts.get("tile_down_a") == 1 and counts.get("tile_down_fin") == 1
               and _launched(counts, down_kernels)
               and not any(counts.get(k, 0) for k in ("tile_pass_a", "tile_pass_c")),
               f"{what}: one downward sweep (T3, the coarse H1 and H0, T4), no upward "
               f"tile kernel; launches {counts}")

    # 1. upscaling
    kernels.reset_launches()
    f1, out1 = _timed(times, "upscale_ihu", lambda: fl.upscale(cs, method="ihu"))
    counts = dict(kernels.launches)
    launched_up(counts, f"upscale({cs}, method='ihu')")
    res["upscale_ihu_launches"] = counts
    shape1 = (-(-H // cs), -(-W // cs))
    o1 = out1.ravel()
    has1 = o1 >= 0
    cell1 = np.flatnonzero(has1)
    own = upscale.subidx_2_idx(o1[has1], W, cs, shape1[1])
    away = cell1[own != cell1]  # IHU's last round may set a pit in a neighbour cell
    upa1 = f1.upstream_area()
    _check(f1.shape == shape1 and f1.device.type == "cuda" and f1.isvalid
           and f1.idxs_pit.size >= 1
           and bool(np.all(f1.idxs_ds[away] == away))
           and bool(upscale.in_d8(cell1, own, shape1[1]).all())
           and int(upa1.ravel()[f1.idxs_pit].sum()) == int(f1.mask.sum()),
           f"upscale: a valid {shape1[0]}x{shape1[1]} raster on the card, "
           f"{f1.idxs_pit.size} pits; each of {int(has1.sum())} outlet pixels in its own "
           f"lowres cell but {away.size} pits in a neighbour cell (pit_out_of_cell); its "
           "upstream_area() summing over its pits to its valid count")
    err1 = _timed(times, "upscale_error", lambda: fl.upscale_error(f1, out1))
    res["ihu_disconnected"] = int((err1 == 0).sum())
    print(f"  ihu: {res['ihu_disconnected']} of {int(f1.mask.sum())} cells disconnected "
          f"(upscale_error)")
    lowres = {"ihu": (f1, out1)}
    for m in ("dmm", "eam", "eam_plus"):
        fm, om = _timed(times, f"upscale_{m}", lambda: fl.upscale(cs, method=m, uparea=upa))
        res[f"{m}_disconnected"] = int((fl.upscale_error(fm, om) == 0).sum())
        lowres[m] = (fm, om)
        om = om.ravel()
        cell = np.flatnonzero(om >= 0)
        _check(fm.isvalid and np.array_equal(
            upscale.subidx_2_idx(om[cell], W, cs, shape1[1]), cell),
            f"upscale(method='{m}'): valid, each outlet pixel in its own lowres cell; "
            f"{res[f'{m}_disconnected']} cells disconnected")
    # the banded IHU on memory maps of the same inputs
    upa64 = upa.ravel().astype(np.float64)
    ids_m, out_m, _ = _timed(times, "ihu_module_float64", lambda: upscale.ihu(
        ids, upa64, fl.shape, cs))
    tmp = tempfile.mkdtemp(prefix="_plan_tmp", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        fd = np.memmap(os.path.join(tmp, "ds.bin"), np.int64, "w+", shape=(n,))
        fu = np.memmap(os.path.join(tmp, "upa.bin"), np.float64, "w+", shape=(n,))
        fd[:], fu[:] = ids, upa64
        fd.flush()
        fu.flush()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            ids_t, out_t, _ = _timed(times, "ihu_tiled", lambda: upscale.ihu_tiled(
                fd, fu, fl.shape, cs, band_rows=64))
        del fd, fu
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    esc = [str(w.message) for w in rec if "halo" in str(w.message)]
    differ = int((ids_t != ids_m).sum() + (out_t != out_m).sum())
    res["ihu_tiled_escapes"] = int(esc[0].split()[0]) if esc else 0
    res["ihu_tiled_cells_differ"] = differ
    if esc:
        print(f"  ihu_tiled(band_rows=64): {esc[0]}; {differ} lowres values differ from ihu")
    else:
        _check(differ == 0, "ihu_tiled(band_rows=64) on int64 / float64 memory maps: no walk "
               "left its halo, bitwise equal to ihu() on the same inputs")
    print(f"  ihu with the int32 upstream area (the object's) equal to the float64 one: "
          f"{np.array_equal(ids_m, f1.idxs_ds) and np.array_equal(out_m, o1)}")
    # a crop upscaled on the card and on the CPU
    zc = z[:UPSCALE_CROP, :UPSCALE_CROP]
    d8c = pyflwdir_torch.fill_depressions(zc, nodata=-9999.0)[1]
    fc = pyflwdir_torch.from_array(d8c, transform=fl.transform, latlon=True, device=dev)
    fh = pyflwdir_torch.from_array(d8c, transform=fl.transform, latlon=True, device="cpu")
    for m in ("ihu", "eam_plus", "eam", "dmm"):
        gc, oc = fc.upscale(cs, method=m)
        gh, oh = fh.upscale(cs, method=m)
        _check(gc.device.type == "cuda" and np.array_equal(gc.idxs_ds, gh.idxs_ds)
               and np.array_equal(oc, oh),
               f"{UPSCALE_CROP}x{UPSCALE_CROP} crop, {m}: the card bitwise equal to the CPU run")
    uc = fc.upstream_area().ravel().astype(np.float64)
    tc = upscale.ihu_tiled(fc.idxs_ds, uc, fc.shape, cs, band_rows=16)
    th = upscale.ihu_tiled(fh.idxs_ds, uc, fh.shape, cs, band_rows=16, device="cpu")
    _check(all(np.array_equal(a, b) for a, b in zip(tc[:2], th[:2])),
           f"{UPSCALE_CROP}x{UPSCALE_CROP} crop, ihu_tiled(band_rows=16): the card bitwise "
           "equal to the CPU run")
    del fc, fh, lowres, f1, ids_m, out_m, ids_t, out_t

    # 2. unit catchments
    kernels.reset_launches()
    outs = _timed(times, "ucat_outlets", lambda: fl.ucat_outlets(cs))
    counts = dict(kernels.launches)
    launched_up(counts, f"ucat_outlets({cs})")
    res["ucat_outlets_launches"] = counts
    o = outs.ravel()
    has = o >= 0
    m = o.size
    kernels.reset_launches()
    lab, acell = _timed(times, "ucat_area_cell", lambda: fl.ucat_area(outs, unit="cell"))
    _check(not any(kernels.launches.values()), "ucat_area: no kernel launched (torch ops)")
    lf = lab.ravel()
    inl = lf > 0
    want = np.zeros(m, np.int64)
    np.add.at(want, lf[inl] - 1, 1)
    _check(acell.dtype == np.int32 and np.array_equal(acell.ravel(), np.where(has, want, -9999)),
           f"ucat_area(unit='cell'): {int(has.sum())} catchments, bitwise equal to np.add.at "
           "over a host copy of the labels")
    pos = np.full(n, -1, np.int64)
    pos[o[has]] = np.flatnonzero(has)
    seeds = rng.choice(np.flatnonzero(valid), ORACLE_CELLS, replace=False)
    off, data, _ = runtime.trace_walks(ids, seeds, mask=pos >= 0)
    last = data[off[1:] - 1]
    _check(np.array_equal(lf[seeds], np.where(pos[last] >= 0, pos[last] + 1, 0)),
           f"ucat_area: at {ORACLE_CELLS} seeded cells the label is the first outlet at or "
           "below the cell (host walks), 0 where the walk ends at a pit")
    area = np.asarray(fl.area).ravel()
    akm = _timed(times, "ucat_area_km2", lambda: fl.ucat_area(outs, unit="km2"))[1].ravel()
    akm2 = fl.ucat_area(outs, unit="km2")[1].ravel()
    ok, worst = _rule(akm, np.bincount(lf[inl] - 1, weights=area[inl] / 1e6, minlength=m),
                      lf, area / 1e6, _EPS, has)
    _check(np.array_equal(akm.view(np.int64), akm2.view(np.int64)) and ok,
           f"ucat_area(unit='km2'): two calls the same bits, per catchment within (k - 1) "
           f"eps sum|term| of a float64 numpy sum ({worst:.2e} of it)")
    vol = _timed(times, "ucat_volume", lambda: fl.ucat_volume(outs, hnd))[1]
    vol2 = fl.ucat_volume(outs, hnd)[1]
    depths = np.arange(0.5, 3.0, 0.5, dtype=np.float32)
    hf = np.asarray(hnd).ravel()
    worst_v = 0.0
    for i, d in enumerate(depths):
        terms = (area * np.maximum(0.0, np.float64(d) - hf)).astype(np.float32)
        want_v = np.bincount(lf[inl] - 1, weights=terms[inl].astype(np.float64), minlength=m)
        ok, w_ = _rule(vol[i].ravel(), want_v, lf, terms.astype(np.float64),
                       np.finfo(np.float32).eps, has)
        _check(ok, f"ucat_volume at depth {d}: within (k - 1) eps32 sum|term| per catchment")
        worst_v = max(worst_v, w_)
    _check(vol.dtype == np.float32 and np.array_equal(vol, vol2)
           and bool(np.all(np.diff(vol.reshape(depths.size, -1)[:, has], axis=0) >= 0)),
           f"ucat_volume: float32, two calls the same bits, rising with depth (largest error "
           f"{worst_v:.2e} of the limit)")
    del lab, lf, inl, want, hf, vol, vol2

    # 3. sub-grid rivers
    kernels.reset_launches()
    rl_up = _timed(times, "subgrid_rivlen_up", lambda: fl.subgrid_rivlen(outs, direction="up"))
    res["subgrid_rivlen_launches"] = dict(kernels.launches)
    launched_down(res["subgrid_rivlen_launches"], "subgrid_rivlen (cells: stream_distance())")
    rl_dn = _timed(times, "subgrid_rivlen_down", lambda: fl.subgrid_rivlen(
        outs, direction="down"))
    _check(all(bool(np.all((r.ravel()[has] >= 0) | (r.ravel()[has] == -9999)))
               and bool(np.all(r.ravel()[~has] == -9999)) for r in (rl_up, rl_dn)),
           "subgrid_rivlen up and down: each length >= 0 or -9999, -9999 at missing outlets")
    fl._cached.pop("distnc", None)
    kernels.reset_launches()
    slp = _timed(times, "subgrid_rivslp_both", lambda: fl.subgrid_rivslp(
        outs, elev, length=1000, direction="both", method="lstsq"))
    res["subgrid_rivslp_launches"] = dict(kernels.launches)
    launched_down(res["subgrid_rivslp_launches"], "subgrid_rivslp (distnc: stream_distance('m'))")
    slp_up = _timed(times, "subgrid_rivslp_up", lambda: fl.subgrid_rivslp(
        outs, elev, direction="up"))
    _check(all(bool(np.all(np.isfinite(s_) & ((s_ >= 0) | (s_ == -9999)))) for s_ in (slp, slp_up)),
           "subgrid_rivslp both (lstsq, 1000 m) and up: finite, >= 0 or -9999")
    data = (rng.rand(n) * 100).astype(np.float32)
    data[rng.rand(n) < 0.05] = -9999.0
    avg = _timed(times, "subgrid_rivavg", lambda: fl.subgrid_rivavg(outs, data)).ravel()
    med = _timed(times, "subgrid_rivmed", lambda: fl.subgrid_rivmed(outs, data)).ravel()
    sel = np.sort(rng.choice(np.flatnonzero(has), MEDIAN_OUTLETS, replace=False))
    # the walks stop at any outlet pixel: walk from all, keep the sampled ones
    off, pix, _, _ = runtime.channel_paths(fl.idxs_us_main, o)
    segs = [data[pix[off[i]:off[i + 1]]].astype(np.float64) for i in sel]
    want_m = np.full(sel.size, -9999.0, np.float32)
    want_a = np.full(sel.size, np.nan)
    k = np.zeros(sel.size, np.int64)
    for i, v in enumerate(segs):
        v = v[v != -9999.0]
        if v.size:
            want_m[i] = np.nanmedian(v)
            want_a[i] = v.mean()
            k[i] = v.size
    good = k > 0
    _check(np.array_equal(med[sel], want_m),
           f"subgrid_rivmed: bitwise equal to np.nanmedian of the segments at {sel.size} "
           f"outlets ({int(good.sum())} with data)")
    tol = 0.5 * np.spacing(np.abs(want_a[good]).astype(np.float32)) + 2 * k[good] * _EPS * (
        np.abs(want_a[good]))
    err = np.abs(avg[sel][good] - want_a[good])
    _check(bool(np.all(err <= tol)) and bool(np.all(avg[sel][~good] == -9999.0)),
           f"subgrid_rivavg: within half a float32 ulp plus 2 k eps64 of the float64 segment "
           f"means at {sel.size} outlets (largest {float(np.max(err / tol, initial=0)):.2e} "
           "of it)")
    feats = _timed(times, "streams_idxs_out", lambda: fl.streams(idxs_out=outs))
    _check(len(feats) > 0, f"streams(idxs_out=...): {len(feats)} features")
    res["streams_idxs_out_features"] = len(feats)
    del rl_up, rl_dn, slp, slp_up, avg, med, segs, feats, data

    # 4. DEM steps
    slope = _timed(times, "slope", lambda: pyflwdir_torch.slope(
        elev, nodata=-9999.0, latlon=True, transform=fl.transform)).cpu().numpy()
    _check(slope.dtype == np.float32 and np.array_equal(
        slope, _slope_np(elev, -9999.0, fl.transform)),
        "slope(latlon=True) on the card bitwise equal to a numpy copy of the JAX formula")
    del slope
    kernels.reset_launches()
    fld = _timed(times, "floodplains", lambda: fl.floodplains(elev, upa_min=FLOOD_KM2)).ravel()
    res["floodplains_launches"] = dict(kernels.launches)
    launched_up(res["floodplains_launches"], "floodplains (the upstream area in km2)")
    upa_km2 = fl.upstream_area("km2").ravel()
    stream = (upa_km2 >= FLOOD_KM2) & valid
    z32 = elev.ravel().astype(np.float32)
    t, pathmax = _flood_np(ids, fl.rank.ravel(), z32, stream)
    margin = pathmax - z32[t]
    # b = 0: a threshold of 1 m, which this DEM's relief crosses
    for b, got in ((0.3, fld), (0.0, fl.floodplains(elev, upa_min=FLOOD_KM2, b=0.0).ravel())):
        with np.errstate(invalid="ignore"):  # -9999 at missing cells, masked below
            thresh = upa_km2[t].astype(np.float32) ** np.float32(b)
        want = np.where(valid, np.where(stream | (stream[t] & (margin <= thresh)), 1, 0), -1)
        near = valid & (np.abs(margin - thresh) <= np.spacing(thresh))
        diff = got != want
        _check(not np.any(diff & ~near),
               f"floodplains(upa_min={FLOOD_KM2}, b={b}): equal to a host sweep over the rank "
               f"levels but {int(diff.sum())} cells, each within an ulp of its threshold "
               f"({int(near.sum())} cells within an ulp; {int((got == 1).sum())} floodplain "
               f"or stream cells of {int(valid.sum())})")
    del t, pathmax, margin, thresh, near, diff, want
    dig = _timed(times, "dem_dig_d4", lambda: fl.dem_dig_d4(elev)).ravel()
    _check(dig.dtype == np.float64 and bool(np.all(np.isfinite(dig))),
           f"dem_dig_d4: finite, {int((dig != elev.ravel()).sum())} cells changed")
    adj = _timed(times, "dem_adjust", lambda: fl.dem_adjust(elev)).ravel()
    down = valid & ~pit & (fl.rank.ravel() >= 0)
    _check(bool(np.all(adj[dsl[down]] <= adj[down])),
           f"dem_adjust: no valid cell below its downstream cell, "
           f"{int((adj != elev.ravel()).sum())} cells changed")
    del fld, dig, adj

    # 5. rivers
    dst = np.asarray(fl.distnc).ravel()
    rivwth = (1000.0 * np.exp(-dst / 20000.0) + rng.rand(n) * 20).astype(np.float32)
    max_elv = float(np.median(elev.ravel()[pit]))
    kernels.reset_launches()
    est = _timed(times, "classify_estuaries", lambda: fl.classify_estuaries(
        elev, rivwth, max_elevtn=max_elv))
    _check(not any(kernels.launches.values()), "classify_estuaries: no kernel (torch ops)")
    dx = dst - dst[dsl]
    dw = rivwth[dsl] - rivwth
    fwd = dx > 0
    conv = np.where(fwd, dw / np.where(fwd, dx, np.float32(1)), np.float32(0))
    cond = ((dst[dsl] == 0) & (dw <= 0)) | (fwd & (conv > 1e-2))
    cond &= valid & ~pit
    seed = pit & (elev.ravel() <= max_elv)
    fails = runtime.downward_sweep(ids, seq, (valid & ~pit & ~cond).astype(np.float64))
    root_seed = runtime.downward_sweep(ids, seq, seed.astype(np.float64))
    chain = np.where(pit, seed, valid & (fails == 0) & (root_seed > 0))
    fail = valid & ~pit & ~cond & chain[dsl]
    below = np.bincount(dsl[fail], minlength=n) > 0
    want = np.where(chain & below, 2, chain.astype(np.int8)).astype(np.int8)
    _check(est.dtype == np.int8 and np.array_equal(est, want),
           f"classify_estuaries: bitwise equal to host sweeps of the rule (native downward "
           f"sweeps); {int((est == 1).sum())} estuary cells, {int((est == 2).sum())} "
           f"upstream ends, {int(seed.sum())} seed pits")
    q = rng.rand(n) * 1000 + 1
    dph = _timed(times, "river_depth_manning", lambda: fl.river_depth(
        q, rivwth + 5, zs=elev, rivdst=dst)).ravel()
    _check(bool(np.all(np.isfinite(dph[valid]) & (dph[valid] >= 1)))
           and bool(np.all(dph[~valid] == -9999.0)),
           "river_depth(method='manning'): finite and >= 1 m on valid cells, -9999 elsewhere")
    res["times_s"] = times
    return res


class _PlanBuilds:
    """Records the seconds of every tile-plan build made inside the block."""

    def __enter__(self):
        from pyflwdir_torch.ops import tile_plan

        self.seconds, self.plans = [], []
        self._mod, self._real = tile_plan, tile_plan.build_tile_plan

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            tp = self._real(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            self.plans.append(tp)
            return tp

        tile_plan.build_tile_plan = timed
        return self

    def __exit__(self, *exc):
        self._mod.build_tile_plan = self._real


def tile_down_path(fl, tp, elev, upa, seq, dev):
    """The downward sweep on the 6000x6000 grid; returns its kernel rows and
    timings. ``upa`` is the grid's upstream area in cells, ``seq`` its cells
    with downstream ones first."""
    from pyflwdir_torch import kernels, runtime
    from pyflwdir_torch.utils import geodesy

    print(" downward path:")
    t0 = time.perf_counter()
    tp._ensure_down()
    t_down = time.perf_counter() - t0
    steps = ", ".join(f"{k} {v:.2f}" for k, v in tp.down_build_seconds.items())
    print(f"  setup: down indices {t_down:.2f} s ({steps})")
    co = tp.coarse
    n_c = co._down_t["es_in"].numel()

    rows = {}
    for dtype in (torch.int32, torch.float64):
        print(f" kernel phase, downward ({_DT[dtype]}):")
        rows[dtype] = tile_down_kernel_phase(tp, dtype, dev)

    print(" main path, downward:")
    drain = upa > DRAIN_CELLS
    with _PlanBuilds() as builds:
        kernels.reset_launches()
        t0 = time.perf_counter()
        dist = fl.stream_distance()
        bas = fl.basins()
        torch.cuda.synchronize()
        t_int = time.perf_counter() - t0
        counts_int = dict(kernels.launches)
        kernels.reset_launches()
        t0 = time.perf_counter()
        dist_m = fl.stream_distance(unit="m")
        hnd = fl.hand(drain, elev)
        torch.cuda.synchronize()
        t_f64 = time.perf_counter() - t0
        counts_f64 = dict(kernels.launches)
    print(f"  stream_distance() + basins() {t_int:.3f} s; launches {counts_int}")
    print(f"  stream_distance('m') + hand() {t_f64:.3f} s; launches {counts_f64}")
    print("  cut-graph tile plans (basins, hand): "
          + ", ".join(f"{v:.2f} s" for v in builds.seconds))
    _check(len(builds.seconds) == 2, "basins() and hand() each built a cut-graph plan")
    # each sweep: T3 once, the coarse level's 2 H1 and 4 H0 calls, T4 once
    want = {"tile_down_a": 2, "accel_in_scan": 4, "permute_gather": 8, "tile_down_fin": 2}
    for counts, what in ((counts_int, "int32"), (counts_f64, "float64")):
        _check(all(counts[k] == want.get(k, 0) for k in counts),
               f"two downward sweeps ({what}) launched T3, H1 x2, H0 x4 and T4 each, "
               "and no upward kernel")

    t0 = time.perf_counter()
    shape = fl.shape
    mask, ids = fl.mask, fl.idxs_ds
    ar = np.arange(fl.size, dtype=np.int64)
    moving = (ids >= 0) & (ids != ar)
    want = runtime.downward_sweep(ids, seq, moving.astype(np.float64))
    _check(dist.dtype == np.int32 and dist.shape == shape, "stream_distance() int32 of the grid's shape")
    _check(np.array_equal(dist.ravel(), np.where(mask, want, -9999).astype(np.int32)),
           "stream_distance() bitwise equal to the native downward sweep, -9999 outside "
           "the mask")
    w32 = np.asarray(geodesy.distance_grid(ids, shape, latlon=True, transform=fl.transform),
                     np.float32).ravel()
    w32 = np.where(moving, w32, 0).astype(np.float32)
    want = sweep_m = runtime.downward_sweep(ids, seq, w32)
    # float64 sums of float32 steps, rounded to float32 at the end (6e-8);
    # the sums run over two tile scans and two coarse scans in another order
    length = 2 * (128 * 128 + 2 * _scan_len(n_c))
    atol = 2 * length * _EPS * float(w32.sum(dtype=np.float64))
    err = float(np.abs(dist_m.ravel()[mask] - want[mask]).max())
    _check(dist_m.dtype == np.float32 and np.allclose(dist_m.ravel()[mask], want[mask],
                                                      rtol=1e-6, atol=atol),
           f"stream_distance('m') float32 within rtol 1e-6, atol 2 L eps total = {atol:.3e} "
           f"of the float64 sweep (L {length}; max |err| {err:.3e} m of up to "
           f"{float(want[mask].max()):.0f} m)")
    lab = np.zeros(fl.size)
    lab[fl.idxs_pit] = np.arange(1, fl.idxs_pit.size + 1)
    want = runtime.downward_sweep(ids, seq, lab)
    flat = bas.ravel()
    _check(bas.dtype == np.uint32 and np.array_equal(flat, np.where(mask, want, 0).astype(np.uint32)),
           f"basins() uint32 bitwise equal to the host label propagation "
           f"({fl.idxs_pit.size} basins), 0 outside the mask")
    _check(np.array_equal(flat[mask], flat[ids[mask]]) and bool((flat[mask] > 0).all()),
           "basins() constant along every flow path")
    _check_hand(fl, hnd, elev, drain, DRAIN_CELLS)

    fdata = np.random.RandomState(SEED + 3).rand(fl.size)
    xd = torch.as_tensor(fdata, device=dev)
    a = tp.accumulate_down(xd)
    _check(torch.equal(a, tp.accumulate_down(xd)),
           "accumulate_down(float64) gives the same bits from run to run")
    want = runtime.downward_sweep(ids, seq, fdata)
    _close(a.cpu().numpy(), want, length, float(fdata[mask].sum()),
           "accumulate_down(float64) of the native downward sweep")
    print(f"  checks {time.perf_counter() - t0:.2f} s")

    ones = torch.ones(fl.size, dtype=torch.int32, device=dev)
    acc_ms = _time_ms(lambda: tp.accumulate_down(ones), reps=20, warmup=3)
    acc_dev_ms = _device_ms(lambda: tp.accumulate_down(ones))
    sd_ms = _host_ms(fl.stream_distance, 3)
    print(f"  accumulate_down: median {acc_ms:.4f} ms per call, "
          f"{fl.size / acc_ms / 1e3:.1f} Mgp/s; device busy {acc_dev_ms} ms of it; "
          f"stream_distance() with host work and copies median {sd_ms:.3f} ms")
    out = _rows(rows[torch.int32], counts_int, "tile 6000x6000 down", "int32")
    out += _rows(rows[torch.float64], counts_f64, "tile 6000x6000 down", "float64")
    return out, dict(accumulate_down_ms=acc_ms, accumulate_down_device_ms=acc_dev_ms,
                     stream_distance_ms=sd_ms, main_path_int32_s=t_int,
                     main_path_float64_s=t_f64, down_indices_s=t_down,
                     down_indices_steps_s=tp.down_build_seconds,
                     cut_plan_s=builds.seconds, coarse_n_down=n_c), dict(
        hand=hnd, stream_distance=dist, basins=bas, drain=drain, stream_distance_m_sweep=sweep_m)


def _check_hand(fl, hnd, elev, drain, drain_cells, cut=None):
    """hand() against a host sweep over the graph cut at the drains; ``cut``
    holds that graph and its cells, downstream first, where the caller has
    them."""
    from pyflwdir_torch import runtime

    mask, ar = fl.mask, np.arange(fl.size, dtype=np.int64)
    dr = drain.ravel() & mask
    ids2, seq2 = cut if cut is not None else (np.where(dr, ar, fl.idxs_ds), None)
    if seq2 is None:
        seq2 = runtime.dfs_preorder(ids2)[0]
    z32 = np.asarray(elev, np.float32).ravel()
    root = (ids2 == ar) & mask
    zroot = runtime.downward_sweep(ids2, seq2, np.where(root, z32, 0)).astype(np.float32)
    want = np.where(dr, 0.0, np.where(mask, (z32 - zroot).astype(np.float64), -9999.0))
    _check(hnd.dtype == np.float64 and np.array_equal(hnd.ravel(), want),
           f"hand() bitwise equal to the host oracle ({int(dr.sum())} drain cells above "
           f"{drain_cells} cells of upstream area; one float32 subtraction per cell)")
    _check(bool((hnd.ravel()[mask] >= 0).all()), "hand() of the filled DEM is never negative")


def big_kernel_phase(plan, dtype, dev):
    """H1-H3 in ``dtype`` against their plain versions at the 1-D
    BigAccelPlan's shapes, on its own indices: H1 gathers cells into
    preorder (``src_in``), H3 preorder back to cells (``src_res``). In
    float64, two H1 calls on one input must give the same bits. H0 on H1's
    gather (``src_in``) is timed beside H1 as a yardstick, not a row: the
    1-D path no longer runs it."""
    from pyflwdir_torch import kernels

    rng = np.random.RandomState(SEED + 4)
    n_cells, n_pad = plan.n_cells, plan.n_pad
    if dtype == torch.float64:
        x = torch.as_tensor(rng.rand(n_cells), device=dev)
    else:
        x = torch.as_tensor(rng.randint(0, 3, n_cells).astype(np.int32), device=dev)
    total = float(x.double().sum())
    s = x.element_size()
    t = plan._t
    n_read = int((t["src_in"] < n_cells).sum())
    n_off = int((t["src_res"] < 0).sum())
    c = kernels.accel_in_scan(x, t["src_in"])
    outp = kernels.accel_near_out(c, t["end"])
    xpad = torch.zeros(n_pad + 1, dtype=dtype, device=dev)
    xpad[:n_cells] = x
    sfx = f".big.{_DT[dtype]}"
    if dtype == torch.float64:
        again = kernels.accel_in_scan(x, t["src_in"])
        _check(torch.equal(c.view(torch.int64), again.view(torch.int64)),
               f"two float64 accel_in_scan calls at {n_pad} slots give the same bits")
    h0_in = dict(ms=_time_ms(lambda: kernels.permute_gather(xpad, t["src_in"]), reps=20),
                 device_ms=_device_ms(lambda: kernels.permute_gather(xpad, t["src_in"])))
    print(f"  yardstick: permute_gather on H1's gather (src_in): {h0_in['ms']:.4f} ms per "
          f"call, {h0_in['device_ms']} ms on the device")
    rows = {
        "accel_in_scan" + sfx: _measure(
            "accel_in_scan" + sfx,
            lambda: kernels.accel_in_scan(x, t["src_in"]),
            lambda: kernels.accel_in_scan_plain(x, t["src_in"]),
            lambda: torch.cumsum(xpad[t["src_in"]], 0),
            4 * n_pad + s * n_read + s * n_pad, n_pad, dtype,
            (2 * _scan_len(n_pad, dtype), total), reps=20),
        "accel_near_out" + sfx: _measure(
            "accel_near_out" + sfx,
            lambda: kernels.accel_near_out(c, t["end"]),
            lambda: kernels.accel_near_out_plain(c, t["end"]),
            None, _h2_bytes(n_pad, _far_slots(t), s), n_pad, dtype, reps=20),
        "accel_far_merge" + sfx: _measure(
            "accel_far_merge" + sfx,
            lambda: kernels.accel_far_merge(outp, x, t["src_res"]),
            lambda: kernels.accel_far_merge_plain(outp, x, t["src_res"]),
            None, _h3_bytes(n_cells, n_off, s, True), 0, dtype, reps=20),
    }
    rows["accel_in_scan" + sfx]["yardstick_permute_gather_in"] = h0_in
    return rows


def cap_check(dev):
    """H0 and H1 at 2^28 slots (the big router's capacity) in int32, on a
    permutation made on the card, against their plain versions."""
    from pyflwdir_torch import kernels

    n = 1 << 28
    gen = torch.Generator(device=dev).manual_seed(SEED)
    src = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    x = torch.randint(0, 3, (n - 1000,), dtype=torch.int32, device=dev, generator=gen)
    got = kernels.accel_in_scan(x, src)
    torch.cuda.synchronize()
    _check(torch.equal(got, kernels.accel_in_scan_plain(x, src)),
           "accel_in_scan at 2^28 slots (131,072 tiles) bitwise equal to its plain version")
    h1_ms = _time_ms(lambda: kernels.accel_in_scan(x, src), reps=3, warmup=1)
    out = kernels.permute_gather(got, src)
    torch.cuda.synchronize()
    _check(torch.equal(out, kernels.permute_gather_plain(got, src)),
           "permute_gather at 2^28 elements bitwise equal to its plain version")
    h0_ms = _time_ms(lambda: kernels.permute_gather(got, src), reps=3, warmup=1)
    print(f"  at 2^28 slots, a uniform random permutation: accel_in_scan {h1_ms:.3f} ms, "
          f"permute_gather {h0_ms:.3f} ms per call")
    del src, x, got, out
    torch.cuda.empty_cache()
    return dict(accel_in_scan_ms=h1_ms, permute_gather_ms=h0_ms)


def big_path(fl_r, upa, seq, tile_acc, dev):
    """The 6000x6000 graph as a 1-D ``Flwdir``, through BigAccelPlan; returns
    its kernel rows and timings. ``fl_r`` is the raster object, ``upa`` its
    upstream area in cells by the tile plan, ``seq`` its cells with
    downstream ones first, ``tile_acc`` the tile plan's accumulate times."""
    import pyflwdir_torch
    from pyflwdir_torch import kernels, runtime

    print("1-D path (the 6000x6000 graph as a Flwdir):")
    n = fl_r.size
    mask, ids = fl_r.mask, fl_r.idxs_ds
    fl = pyflwdir_torch.Flwdir(ids, idxs_pit=fl_r.idxs_pit)
    t0 = time.perf_counter()
    dfs = fl._plan
    t_dfs = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = fl._accel()
    t_plan = time.perf_counter() - t0
    print(f"  setup: DFS plan {t_dfs:.2f} s, router plan {t_plan:.2f} s; {n} nodes, "
          f"{dfs.n_tree} on the tree; {type(plan).__name__} n_pad {plan.n_pad}, G1 {plan.G1}, "
          f"far intervals {int((plan.far_end >= 0).sum())}")
    _check(type(plan).__name__ == "BigAccelPlan" and plan.G1 == 18
           and plan.n_pad == 18 << 21 and not plan.slot_mode and plan.has_far,
           "the 1-D path takes a BigAccelPlan of G1 = 18, with far intervals")

    rows = {}
    for dtype in (torch.int32, torch.float64):
        print(f" kernel phase ({_DT[dtype]}):")
        rows[dtype] = big_kernel_phase(plan, dtype, dev)
    print(" capacity check:")
    cap = cap_check(dev)

    print(" main path:")
    fdata = np.random.RandomState(SEED + 1).rand(n)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    a32 = fl._accumulate_dev(ones).cpu().numpy()
    torch.cuda.synchronize()
    t_int = time.perf_counter() - t0
    counts_int = dict(kernels.launches)
    kernels.reset_launches()
    t0 = time.perf_counter()
    up1 = fl.upstream_area()
    acc = fl.accuflux(fdata)
    torch.cuda.synchronize()
    t_f64 = time.perf_counter() - t0
    counts_f64 = dict(kernels.launches)
    print(f"  int32 accumulate {t_int:.3f} s; launches {counts_int}")
    print(f"  upstream_area() + accuflux(float64) {t_f64:.3f} s; launches {counts_f64}")
    for counts, calls, what in ((counts_int, 1, "int32"), (counts_f64, 2, "float64")):
        _check(all(counts[k] == (calls if k in _UP else 0) for k in counts),
               f"{calls} accumulation(s) ({what}) launched H1, H2 and H3 once each, and no H0 "
               "or tile kernel")

    t0 = time.perf_counter()
    oracle = runtime.accuflux_sweep(ids, seq, np.ones(n))
    _check(a32.dtype == np.int32 and np.array_equal(a32[mask], upa.ravel()[mask]),
           "accumulate(int32 ones) bitwise equal to the tile plan's upstream area")
    _check(np.array_equal(a32[mask], oracle[mask].astype(np.int32)),
           "accumulate(int32 ones) bitwise equal to the native sequential sweep")
    _check(int(a32[fl.idxs_pit].sum()) == int(mask.sum()),
           "mass conservation: pit sums equal the valid count")
    # unit areas are float32: summed in float64, rounded once at the end
    _check(np.array_equal(up1[mask], oracle[mask].astype(np.float32))
           and bool(np.all(up1[~mask] == -9999)),
           "upstream_area() (float32 unit areas) bitwise equal to the sweep rounded to "
           "float32, -9999 outside the mask")
    want = runtime.accuflux_sweep(ids, seq, fdata)
    # one prefix sum over n_pad slots, in another order than the sweep
    _close(acc, want, 2 * _scan_len(plan.n_pad), float(fdata.sum()),
           "accuflux(float64) of the native sweep")
    _check(np.array_equal(acc.view(np.int64), fl.accuflux(fdata).view(np.int64)),
           "two accuflux(float64) sweeps give the same bits")
    print(f"  checks {time.perf_counter() - t0:.2f} s")

    xd = torch.as_tensor(fdata, device=dev)
    out = {}
    for name, data in (("int32", ones), ("float64", xd)):
        ms = _time_ms(lambda: fl._accumulate_dev(data), reps=20, warmup=3)
        dev_ms = _device_ms(lambda: fl._accumulate_dev(data))
        out[name] = dict(ms=ms, device_ms=dev_ms)
        print(f"  accumulate ({name}): median {ms:.4f} ms per call, {n / ms / 1e3:.1f} Mgp/s; "
              f"device busy {dev_ms} ms of it")
    print(f"  the tile plan on the same graph (int32): {tile_acc['ms']:.4f} ms per call, "
          f"device busy {tile_acc['device_ms']} ms")
    krows = _rows(rows[torch.int32], counts_int, "1-D 6000x6000 graph", "int32")
    krows += _rows(rows[torch.float64], counts_f64, "1-D 6000x6000 graph", "float64")
    return krows, dict(accumulate=out, dfs_plan_s=t_dfs, router_plan_s=t_plan, n_pad=plan.n_pad,
                       G1=plan.G1, main_path_int32_s=t_int, main_path_float64_s=t_f64,
                       cap_2_28=cap)


def cut_path(fl, elev, upa, dev):
    """The 6000x6000 grid cut at the drains above ``BIG_DRAIN_CELLS`` cells:
    a tile plan whose coarse level is a BigAccelPlan in slot mode. Kernel
    phase on that plan's tables, then hand(), fillnodata(direction="up") and
    the cut plan's own two sweeps against host sweeps over the cut graph.
    Returns its kernel rows and timings."""
    from pyflwdir_torch import kernels, runtime

    print(f" cut-graph path (drains above {BIG_DRAIN_CELLS} cells):")
    n = fl.size
    mask, ids = fl.mask, fl.idxs_ds
    drain = upa > BIG_DRAIN_CELLS
    dr = drain.ravel() & mask
    label = np.where(dr, upa.ravel(), -1).astype(np.int32)  # nodata -1 off the drains
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    fdata = np.random.RandomState(SEED + 5).rand(n)
    xd = torch.as_tensor(fdata, device=dev)
    with _PlanBuilds() as builds:
        tp = fl._tp_down(cut=drain.ravel())
        tp._ensure_down()
        co = tp.coarse
        print(f"  cut plan: R_pad {tp.R_pad}, E_pad {tp.E_pad}, {tp._coarse_meta['m']} roots + "
              f"{tp._coarse_meta['D']} entry nodes; coarse {type(co).__name__} n_pad "
              f"{getattr(co, 'n_pad', None)}, G1 {getattr(co, 'G1', None)}, n_in "
              f"{getattr(co, 'n_in', None)}, n_out {getattr(co, 'n_out', None)}")
        _check(type(co).__name__ == "BigAccelPlan" and co.slot_mode,
               "the cut plan's coarse level is a BigAccelPlan (slot mode)")

        rows_up, rows_dn = {}, {}
        for dtype in (torch.int32, torch.float64):
            print(f" kernel phase, cut plan ({_DT[dtype]}):")
            rows_up[dtype] = tile_kernel_phase(tp, dtype, dev, ".cut")
            rows_dn[dtype] = tile_down_kernel_phase(tp, dtype, dev, ".cut")

        print(" main path, cut graph:")
        counts = {}

        def counted(name, fn, *args):
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts[name] = dict(kernels.launches)
            print(f"  {name} {secs:.3f} s; launches {counts[name]}")
            return out, secs

        hnd, t_hand = counted("hand()", fl.hand, drain, elev)
        filled, t_fill = counted("fillnodata(direction='up')", fl.fillnodata,
                                 label.reshape(fl.shape), -1, "up")
        up32 = counted("cut plan accumulate(int32)", tp.accumulate, ones)[0]
        upf = counted("cut plan accumulate(float64)", tp.accumulate, xd)[0]
        dnf = counted("cut plan accumulate_down(float64)", tp.accumulate_down, xd)[0]
    c_hand, c_fill, c_up32, c_upf, c_dnf = counts.values()
    print("  cut-graph tile plans (this path's own, hand, fillnodata): "
          + ", ".join(f"{v:.2f} s" for v in builds.seconds))
    _check(len(builds.plans) == 3
           and all(type(p.coarse).__name__ == "BigAccelPlan" and p.coarse.slot_mode
                   for p in builds.plans),
           "hand(), fillnodata() and the cut plan each took a BigAccelPlan coarse level "
           "(slot mode)")
    # each downward sweep: T3 once, the coarse level's 2 H1 and 4 H0 calls, T4 once
    down = {"tile_down_a": 1, "accel_in_scan": 2, "permute_gather": 4, "tile_down_fin": 1}
    for c, sweeps, what in ((c_hand, 1, "hand()"), (c_fill, 2, "fillnodata()"),
                            (c_dnf, 1, "accumulate_down(float64)")):
        _check(all(c[k] == sweeps * down.get(k, 0) for k in c),
               f"{what}: {sweeps} downward sweep(s) launched T3, H1 x2, H0 x4 and T4 each")
    up = {"tile_pass_a": 1, "tile_pass_c": 1, **{k: 1 for k in _UP}}
    for c, what in ((c_up32, "int32"), (c_upf, "float64")):
        _check(all(c[k] == up.get(k, 0) for k in c),
               f"the upward sweep ({what}) launched T1, H1, H2, H3 and T2 once each, and no H0")
    _check(torch.equal(upf, tp.accumulate(xd)) and torch.equal(dnf, tp.accumulate_down(xd)),
           "accumulate and accumulate_down (float64) give the same bits from run to run")

    t0 = time.perf_counter()
    ar = np.arange(n, dtype=np.int64)
    ids2 = np.where(dr, ar, ids)
    seq2 = runtime.dfs_preorder(ids2)[0]
    _check_hand(fl, hnd, elev, drain, BIG_DRAIN_CELLS, cut=(ids2, seq2))
    # the first drain cell downstream hands its label on; cells with none keep -1
    a = runtime.downward_sweep(ids2, seq2, np.where(dr, label, 0))
    ok = runtime.downward_sweep(ids2, seq2, dr.astype(np.float64)) > 0
    want = np.where(mask & ~dr & ok, a, label).astype(np.int32)
    _check(filled.dtype == np.int32 and np.array_equal(filled.ravel(), want)
           and int((want != -1).sum()) > int(dr.sum()),
           f"fillnodata(direction='up') int32 bitwise equal to the host oracle "
           f"({int((want != -1).sum()) - int(dr.sum())} cells filled)")
    want = runtime.accuflux_sweep(ids2, seq2, np.ones(n))
    _check(np.array_equal(up32.cpu().numpy()[mask], want[mask].astype(np.int32)),
           "cut plan accumulate(int32 ones) bitwise equal to the native sweep of the cut graph")
    length = 128 * 128 + 2 * _scan_len(co.n_pad) + tp.E_pad
    total = float(fdata[mask].sum())
    _close(upf.cpu().numpy(), runtime.accuflux_sweep(ids2, seq2, fdata), length, total,
           "cut plan accumulate(float64) of the native sweep")
    _close(dnf.cpu().numpy(), runtime.downward_sweep(ids2, seq2, fdata), 2 * length, total,
           "cut plan accumulate_down(float64) of the native downward sweep")
    print(f"  checks {time.perf_counter() - t0:.2f} s")

    out = {}
    for name, fn in (("accumulate", tp.accumulate), ("accumulate_down", tp.accumulate_down)):
        ms = _time_ms(lambda: fn(ones), reps=20, warmup=3)
        dev_ms = _device_ms(lambda: fn(ones))
        out[name] = dict(ms=ms, device_ms=dev_ms)
        print(f"  cut plan {name} (int32): median {ms:.4f} ms per call, "
              f"{n / ms / 1e3:.1f} Mgp/s; device busy {dev_ms} ms of it")
    for name, fn, arg in (("coarse accumulate", co.accumulate, tp.n_exit_flat),
                          ("coarse accumulate_down", co.accumulate_down, tp.NT * tp.E_pad)):
        x = torch.ones(arg, dtype=torch.int32, device=dev)
        ms = _time_ms(lambda: fn(x), reps=50)
        dev_ms = _device_ms(lambda: fn(x))
        out[name] = dict(ms=ms, device_ms=dev_ms)
        print(f"  {name} alone (int32, {arg} slots in): median {ms:.4f} ms per call, "
              f"device busy {dev_ms} ms")
    # launches: the upward rows from the cut plan's own sweep in their type,
    # the downward rows from fillnodata's two int32 sweeps, and from hand()'s
    # and the cut plan's float64 sweeps
    c_dn64 = {k: c_hand[k] + c_dnf[k] for k in c_hand}
    path = "cut 6000x6000"
    krows = _rows(rows_up[torch.int32], c_up32, path, "int32")
    krows += _rows(rows_up[torch.float64], c_upf, path, "float64")
    krows += _rows(rows_dn[torch.int32], c_fill, path + " down", "int32")
    krows += _rows(rows_dn[torch.float64], c_dn64, path + " down", "float64")
    return krows, dict(out, hand_s=t_hand, fillnodata_s=t_fill, cut_plan_s=builds.seconds,
                       R_pad=tp.R_pad, E_pad=tp.E_pad, roots=tp._coarse_meta["m"],
                       entry_nodes=tp._coarse_meta["D"], coarse_n_pad=co.n_pad, G1=co.G1,
                       n_in=co.n_in, n_out=co.n_out, drain_cells=int(dr.sum()))


def fill_kernel_phase(dem, seeds, bad, conn8, start_rounds, tag):
    """F1 against its plain version on the card, bitwise, a down and an up
    sweep of the fill of ``dem`` from its seeded start advanced by
    ``start_rounds`` rounds; timed beside its plain version (the compared
    call) and its bound. ``tag`` goes into the rows' names."""
    from pyflwdir_torch import kernels

    H, W = dem.shape
    n = H * W
    fixed = (seeds | bad).to(torch.uint8)
    w = torch.where(seeds, dem, float("inf"))
    for _ in range(start_rounds):
        w = kernels.fill_sweep(kernels.fill_sweep(w, dem, fixed, conn8, True), dem, fixed,
                               conn8, False)
    # per cell: m_up (2 min under 8-connectivity), b, the two recurrences
    # (2 each), min(b, new), their minimum, the floor at d and the select
    n_ops = (11 if conn8 else 9) * n
    rows = {}
    for down in (True, False):
        name = f"fill_sweep.{'down' if down else 'up'}{tag}"
        rows[name] = _measure(
            name, lambda: kernels.fill_sweep(w, dem, fixed, conn8, down),
            lambda: kernels.fill_sweep_plain(w, dem, fixed, conn8, down), None,
            # w, dem and the mask read once, w written once
            13 * n, n_ops, torch.float32, reps=5, plain_once=True, dev_reps=3)
        # the operations bound beside the bytes one, and the dependent row
        # steps both ignore
        rows[name].update(ops_bound_ms=n_ops / OPS_PER_S[torch.float32] * 1e3, chain_rows=H,
                          us_per_row=rows[name]["device_ms"] / H * 1e3)
        print(f"  {name}: {rows[name]['us_per_row']:.3f} us per row on the device over {H} "
              f"dependent rows ({rows[name]['ms'] / H * 1e3:.3f} us per row of the call)")
    return rows


def dem_path(z, elev, host_fill_s, dev):
    """DEM -> FlwdirRaster on the card at the 6000x6000 tile: from_dem
    (engine="auto") through the device fill (F1) and d8_from_filled, then
    the new graph's tile plan. ``z`` is the tile path's DEM, ``elev`` its
    host priority flood (the reference) and ``host_fill_s`` that fill's
    seconds. Returns its kernel rows and timings."""
    import pyflwdir_torch
    from pyflwdir_torch import kernels, runtime
    from pyflwdir_torch.codecs import d8 as d8c
    from pyflwdir_torch.ops import fill as tfill

    H, W = z.shape
    print(f"from_dem path ({H}x{W}):")
    print(" kernel phase:")
    dem_t, seeds, bad = tfill.fill_setup(z, nodata=-9999.0, device=dev)
    rows = fill_kernel_phase(dem_t, seeds, bad, True, 0, "")
    rows.update(fill_kernel_phase(dem_t, seeds, bad, True, 3, ".r3"))
    zr = _demo_dem(SHAPE, SEED)
    rows.update(fill_kernel_phase(*tfill.fill_setup(zr, connectivity=4, device=dev), False, 0,
                                  ".conn4.rhine"))
    del dem_t, seeds, bad

    print(" main path:")
    kernels.reset_launches()
    t0 = time.perf_counter()
    fl = pyflwdir_torch.from_dem(z, nodata=-9999.0, transform=TILE_LATLON, latlon=True)
    torch.cuda.synchronize()
    t_dem = time.perf_counter() - t0
    counts = dict(kernels.launches)
    rounds = dict(tfill.last_rounds)
    print(f"  from_dem {t_dem:.3f} s; {rounds['fill']} fill rounds, {rounds['flat']} flat "
          f"rounds; launches {counts}")
    _check(counts["fill_sweep"] == 2 * rounds["fill"] > 0,
           f"from_dem(engine='auto') took the device fill: fill_sweep launched twice in each "
           f"of {rounds['fill']} rounds")
    t0 = time.perf_counter()
    filled = tfill.fill_depressions_dev(z, nodata=-9999.0)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    d8 = tfill.d8_from_filled(filled, nodata=-9999.0)
    torch.cuda.synchronize()
    t_d8 = time.perf_counter() - t0
    print(f"  fill_depressions_dev {t_fill:.3f} s ({tfill.last_rounds['fill']} rounds, "
          f"{t_fill / tfill.last_rounds['fill'] * 1e3:.2f} ms each); d8_from_filled "
          f"{t_d8:.3f} s ({tfill.last_rounds['flat']} flat rounds); the tile path's host fill "
          f"{host_fill_s:.3f} s")

    t0 = time.perf_counter()
    f_np, d8_np = filled.cpu().numpy(), d8.cpu().numpy()
    valid = z != -9999.0
    _check(np.array_equal(f_np[valid], elev[valid].astype(np.float32))
           and bool(np.all(f_np[~valid] == -9999.0)),
           "the filled surface bitwise equal to the host priority flood cast to float32 on "
           f"valid cells ({int(valid.sum())}), nodata outside")
    _check(d8c.isvalid(d8_np) and np.array_equal(d8c.from_array(d8_np, dtype=np.int64)[0],
                                                 fl.idxs_ds),
           "D8 codes valid, and from_dem's graph is the D8 of this fill")
    mask, ids = fl.mask, fl.idxs_ds
    _check(bool((fl.rank.ravel()[mask] >= 0).all()), "no loops: rank >= 0 on every valid cell")
    fz = f_np.ravel()
    moving = mask & (ids != np.arange(fl.size))
    _check(bool(np.all(fz[ids[moving]] <= fz[moving])),
           f"no uphill step ({fl.idxs_pit.size} pits)")
    t_plan = time.perf_counter()
    upa = fl.upstream_area()
    t_upa = time.perf_counter() - t_plan
    seq = runtime.dfs_preorder(ids)[0]
    oracle = runtime.accuflux_sweep(ids, seq, np.ones(fl.size))
    upa = upa.ravel()
    _check(type(fl._cached.get("tile_plan")).__name__ == "TilePlan"
           and np.array_equal(upa[mask], oracle[mask].astype(np.int32)),
           "upstream_area() through the new graph's tile plan bitwise equal to the native "
           "sweep")
    _check(int(upa[fl.idxs_pit].sum()) == int(mask.sum()) and bool(np.all(upa[~mask] == -9999)),
           "mass conservation; -9999 outside the mask")
    print(f"  checks {time.perf_counter() - t0:.2f} s (tile plan + upstream_area() "
          f"{t_upa:.2f} s)")
    del fl, filled, d8

    print(f" crop ({DEM_CROP}x{DEM_CROP}, the low corner with the coast):")
    zc = np.ascontiguousarray(z[-DEM_CROP:, -DEM_CROP:])
    t0 = time.perf_counter()
    fg = tfill.fill_depressions_dev(zc, nodata=-9999.0)
    dg = tfill.d8_from_filled(fg, nodata=-9999.0)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc = tfill.fill_depressions_dev(zc, nodata=-9999.0, device="cpu")
    dc = tfill.d8_from_filled(fc, nodata=-9999.0)
    t_cpu = time.perf_counter() - t0
    _check(torch.equal(fg.cpu(), fc) and torch.equal(dg.cpu(), dc),
           f"the fill and the D8 on the card bitwise equal to the port's CPU run "
           f"({tfill.last_rounds['fill']} rounds; card {t_gpu:.2f} s, CPU {t_cpu:.2f} s)")

    print(f" Rhine shape ({SHAPE[0]}x{SHAPE[1]}):")
    kernels.reset_launches()
    fr = pyflwdir_torch.from_dem(zr, transform=LATLON, latlon=True)
    host = pyflwdir_torch.from_array(pyflwdir_torch.fill_depressions(zr)[1], device="cpu")
    _check(kernels.launches["fill_sweep"] == 0 and np.array_equal(fr.idxs_ds, host.idxs_ds),
           "from_dem(engine='auto') under 2^21 cells takes the host fill: no F1 launch")
    kernels.reset_launches()
    fm = pyflwdir_torch.from_dem(zr, max_depth=0.5, engine="device", transform=LATLON,
                                 latlon=True)
    capped = tfill.fill_depressions_dev(zr, max_depth=0.5).cpu().numpy()
    depth = dict(tfill.last_rounds)
    z32 = zr.astype(np.float32)
    ids, mask = fm.idxs_ds, fm.mask
    moving = mask & (ids != np.arange(fm.size))
    cz = capped.ravel()
    _check(kernels.launches["fill_sweep"] > 0 and bool(np.all(capped - z32 < 0.5))
           and bool(np.all(capped >= z32)),
           f"max_depth 0.5 on the card: the cap holds ({depth['depth']} outer rounds, "
           f"{depth['fill']} fill rounds, {fm.idxs_pit.size} pits)")
    upm = fm.upstream_area().ravel()
    _check(bool((fm.rank.ravel()[mask] >= 0).all()) and bool(np.all(cz[ids[moving]] <= cz[moving]))
           and int(upm[fm.idxs_pit].sum()) == int(mask.sum()),
           "and the capped surface drains: no loop, no uphill step, mass conserved")
    out = _rows(rows, counts, f"from_dem {H}x{W}", "float32")
    return out, dict(from_dem_s=t_dem, fill_s=t_fill, d8_s=t_d8, host_fill_s=host_fill_s,
                     fill_rounds=rounds["fill"],
                     flat_rounds=rounds["flat"], upstream_area_s=t_upa, crop_card_s=t_gpu,
                     crop_cpu_s=t_cpu)


def routed_path(dev):
    """A grid above 2^21 cells whose tiles each drain to a pit of their own:
    no entry cells, so ``accumulate_down`` is T3 in routed mode alone.
    Returns its kernel rows and timings."""
    import pyflwdir_torch
    from pyflwdir_torch import kernels, parallel, runtime

    H, W = ROUTED_SHAPE
    print(f"routed path ({H}x{W}, closed tiles):")
    # east along each row, south along each tile's last column, a pit in
    # the tile's corner; a strip of missing cells
    d8 = np.ones(ROUTED_SHAPE, np.uint8)
    d8[:, 127::128] = 4
    d8[127::128, 127::128] = 0
    d8[:40, 0] = 247
    fl = pyflwdir_torch.from_array(d8, transform=TILE_LATLON, latlon=True)
    t0 = time.perf_counter()
    tp = fl._tile_plan()
    tp._ensure_down()
    print(f"  setup: tile plan and down indices {time.perf_counter() - t0:.2f} s; NT {tp.NT}, "
          f"E_pad {tp.E_pad}, {fl.idxs_pit.size} pits")
    _check(fl.size > fl._TILE_PLAN_MIN and not tp.has_entries and tp.E_pad == 0,
           "above the tile-plan threshold, and the plan has no entry cells")

    rows = {}
    for dtype in (torch.int32, torch.float64):
        print(f" kernel phase ({_DT[dtype]}):")
        rows[dtype] = tile_down_a_rows(tp, dtype, dev, ("routed",), ".noentry")[0]

    print(" main path:")
    kernels.reset_launches()
    dist = fl.stream_distance()
    counts_int = dict(kernels.launches)
    kernels.reset_launches()
    dist_m = fl.stream_distance(unit="m")
    counts_f64 = dict(kernels.launches)
    for counts, what in ((counts_int, "int32"), (counts_f64, "float64")):
        _check(all(counts[k] == (k == "tile_down_a") for k in counts),
               f"stream_distance ({what}) launched T3 once and no other kernel: {counts}")
    mask, ids = fl.mask, fl.idxs_ds
    moving = (ids >= 0) & (ids != np.arange(fl.size))
    seq = runtime.dfs_preorder(ids)[0]
    want = runtime.downward_sweep(ids, seq, moving.astype(np.float64))
    _check(np.array_equal(dist.ravel(), np.where(mask, want, -9999).astype(np.int32))
           and int(dist.max()) == 254,
           "stream_distance() bitwise equal to the native downward sweep (longest path 254)")
    _check(dist_m.dtype == np.float32 and bool(np.isfinite(dist_m).all())
           and bool((dist_m.ravel()[moving] > 0).all()),
           "stream_distance('m') float32, finite, positive off the pits")
    ones = torch.ones(fl.size, dtype=torch.int32, device=dev)
    mesh = parallel.make_mesh()
    kernels.reset_launches()
    sharded = tp.accumulate_down_sharded(ones, mesh)
    counts_sh = dict(kernels.launches)
    _check(all(counts_sh[k] == (k == "tile_down_a") for k in counts_sh)
           and torch.equal(sharded, tp.accumulate_down(ones)),
           "accumulate_down_sharded on one rank launched T3 (routed, on the tile range) once "
           "and no other kernel, bitwise equal to accumulate_down")
    acc_ms = _time_ms(lambda: tp.accumulate_down(ones), reps=20, warmup=3)
    sh_ms = _time_ms(lambda: tp.accumulate_down_sharded(ones, mesh), reps=20, warmup=3)
    print(f"  accumulate_down (T3 routed alone): median {acc_ms:.4f} ms per call, "
          f"{fl.size / acc_ms / 1e3:.1f} Mgp/s; accumulate_down_sharded on one rank "
          f"{sh_ms:.4f} ms")
    path = f"closed tiles {H}x{W}"
    out = _rows(rows[torch.int32], counts_int, path, "int32")
    out += _rows(rows[torch.float64], counts_f64, path, "float64")
    return out, dict(accumulate_down_ms=acc_ms, accumulate_down_sharded_ms=sh_ms, NT=tp.NT)


def ptxas_lines():
    """Registers and spills of the H0, H1, H3, F1 and T1-T4 kernels (T1-T4
    of each tile height: ``.g2`` to ``.g4`` for the cluster kernels), as
    ``nvcc -Xptxas -v`` reported them when the libraries were built."""
    import re

    from pyflwdir_torch import kernels

    out = {}
    for stem in ("accel_kernels", "fill_kernels", *kernels._TILE_LIB.values()):
        sfx = stem[len("tile_kernels_"):] if stem.startswith("tile_kernels_") else ""
        for sym, (nreg, st, ld) in kernels.ptxas_report(stem).items():
            m = re.search(r"(permute_gather_kernel|in_scan_kernel|permute_merge_kernel|"
                          r"fill_sweep_wide_kernel|fill_sweep_kernel|"
                          r"tile_pass_a_kernel|tile_pass_c_kernel|tile_down_a_kernel|"
                          r"tile_down_fin_kernel)(I(?:L[a-z]\d+E|[a-z])+E)?", sym)
            if m:
                name = m.group(1) + (m.group(2) or "") + (f".{sfx}" if sfx else "")
                out[name] = dict(registers=nreg, spill_stores=st, spill_loads=ld)
                print(f"ptxas: {name}: {nreg} registers, {st} B spill stores, {ld} B spill loads")
    return out


def stream_lookup_us():
    """Host microseconds of one read of the current stream: the Stream object
    the wrappers built before (``torch.cuda.current_stream().cuda_stream``)
    against the raw accessor they call now, 20,000 reads each, in turns."""
    index = torch.cuda.current_device()
    ways = {"stream_object": lambda: torch.cuda.current_stream().cuda_stream,
            "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index)}
    got = {k: [] for k in ways}
    for k in ("stream_object", "raw_stream", "raw_stream", "stream_object"):
        t0 = time.perf_counter()
        for _ in range(20_000):
            ways[k]()
        got[k].append((time.perf_counter() - t0) / 20_000 * 1e6)
    out = {k: sum(v) / 2 for k, v in got.items()}
    print(f"stream lookup: current_stream().cuda_stream {out['stream_object']:.3f} us, "
          f"_cuda_getCurrentRawStream {out['raw_stream']:.3f} us per read (host clock)")
    return out


def main(json_path=None):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pyflwdir_torch import kernels, runtime

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # make the host library meanwhile
        host = pool.submit(runtime._lib)
        kernels.load()
        host.result()
    print(f"build: kernels and host library ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'} s)")

    regs = ptxas_lines()
    streams = stream_lookup_us()

    import torch.distributed as dist

    n_cards = torch.cuda.device_count()
    _start_group()
    try:
        rhine_rows, rhine = rhine_path(dev)
        tile_rows, (z, elev, d8, halo), tile = tile_path(dev)
        dem_rows, dem = dem_path(z, elev, tile["fill_s"], dev)
        del z, elev
        routed_rows, routed = routed_path(dev)
    finally:
        dist.destroy_process_group()
    cards = {}
    if n_cards > 1:
        torch.cuda.empty_cache()
        cards = multi_card_path(d8, n_cards, halo=halo)
    del halo

    out = rhine_rows + tile_rows + dem_rows + routed_rows
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(dict(card=smi, rhine=rhine, tile=tile, dem=dem, routed=routed,
                           multi_card=cards, ptxas=regs, stream_lookup_us=streams,
                           kernels=out), f, indent=1)
    for name, times in (("rhine", rhine["surface"]), ("tile", tile["surface"]["times_s"]),
                        ("tile upscale phase", tile["upscale"]["times_s"]),
                        ("tile halo phase, 1 rank", tile["halo"]["times_s"])):
        print(f"surface times, {name} (host clock, synchronised; {smi}): "
              + ", ".join(f"{k} {v:.4f} s" for k, v in times.items()))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(f"card: {smi}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the measurements to this file")
    sys.exit(main(ap.parse_args().json))
