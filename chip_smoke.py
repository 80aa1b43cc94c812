"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root:  python3 chip_smoke.py [--json PATH]
(``--json`` also writes the measurements to PATH).

1. Prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels (one nvcc per ``pyflwdir_torch/csrc/*.cu``, sm_90a, all started
   together) and the native host library from the sources.
2. Rhine path: a 997x682 grid (the Rhine raster's shape) from a seeded DEM,
   under 2^21 cells, so the single-chunk AccelPlan (kernels H0-H3, float32).
   Kernel phase: each kernel against its plain PyTorch version on the
   card, at the shapes the path gives it, bitwise; timed (median of
   CUDA-event timings after warm-up) beside its plain version, one PyTorch
   library call where there is one, and its bound. Then the path itself,
   with the launch counters zeroed before it and read after: fill ->
   from_array -> upstream_area (cells, km2), accuflux, rank and roots,
   checked against the sequential native oracle, mass conservation and a
   CPU run of the port.
3. Tile path: a 6000x6000 grid (one MERIT Hydro 5x5 degree tile at 3
   arcsec) from a seeded DEM with a sea of nodata in one corner, above 2^21
   cells, so the hierarchical TilePlan: kernels T1 and T2 per tile, and
   H0-H3 (int32 and float64) on its coarse level. Kernel phase as above at
   the path's shapes, int32 bitwise and float64 within rtol 1e-12 plus
   2 L eps total, L the length of the sums it takes in another order
   (bitwise where it takes none). Then the path, twice with the counters zeroed: int32
   (upstream_area in cells) and float64 (upstream_area in km2, accuflux),
   checked against the native sequential sweep; then the accumulate call
   and upstream_area are timed.
4. Prints a JSON line of the kernels, the card, then
   {"ok": true, "device": ...}.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

import json
import os
import statistics
import subprocess
import sys
import time
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
# file:line of the TPU kernel, inside the JAX package
_KERNELS = {
    "permute_gather": ("H0", _ACCEL_SRC,
                       "ops/router.py:153 (_ta), ops/router.py:320 (RouterPlan.apply)"),
    "accel_in_scan": ("H1", _ACCEL_SRC,
                      "ops/accel.py:200 (_accumulate_fused k1, pallas_call :226)"),
    "accel_near_out": ("H2", _ACCEL_SRC,
                       "ops/accel.py:200 (_accumulate_fused k2, pallas_call :251)"),
    "accel_far_merge": ("H3", _ACCEL_SRC,
                        "ops/accel.py:200 (_accumulate_fused k3, pallas_call :282)"),
}
_COARSE = {
    "permute_gather": "ops/tile_plan.py:590 (_CoarseRouterSmall._route of r_out, "
                      "pallas_call :613/:635/:650/:664)",
    "accel_in_scan": "ops/tile_plan.py:590 (_CoarseRouterSmall._route of r_in + in_sel, "
                     "pallas_call :613/:635/:650/:664) and the coarse cumsum",
    "accel_near_out": "ops/router_big.py:56 (lane_gather_tiled, pallas_call :83, "
                      "in _CoarseRouterSmall._gather_pair ops/tile_plan.py:672)",
    "accel_far_merge": "ops/router_big.py:56 (lane_gather_tiled, pallas_call :83) and "
                       "ops/tile_plan.py:590 (_route of r_exp/r_far) in "
                       "_CoarseRouterSmall._far_values ops/tile_plan.py:694",
}
_TILE_KERNELS = {
    "tile_pass_a": ("T1", "ops/tile_plan.py:1918 (TilePlan._pass_a_fused, pallas_call :1951)"),
    "tile_pass_c": ("T2", "ops/tile_plan.py:1973 (TilePlan._pass_c_fused, pallas_call :2013)"),
}
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


def _device_ms(fn, reps=20, tries=3):
    """Device time of one call: the sum of its kernels' durations in a
    torch.profiler trace (CUPTI), None when no trace of ``tries`` holds
    device time (a trace sometimes comes back without its kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages())
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def _bound_ms(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def _measure(name, kern, plain, lib, n_bytes, n_ops, dtype, sums=None, reps=50):
    """Hold one kernel against its plain version, then time it, its plain
    version and the library call. Bitwise, unless ``sums`` is ``(L,
    total)`` and the data float64: the kernel then sums L terms up to
    ``total`` in another order (:func:`_close`)."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    if dtype == torch.float64 and sums is not None:
        for g, w in zip(got, want):
            _close(g.cpu().numpy(), w.cpu().numpy(), *sums, f"{name} of its plain version")
    else:
        _check(all(torch.equal(g, w) for g, w in zip(got, want)),
               f"{name} bitwise equal to its plain version")
    ms = _time_ms(kern, reps=reps)
    plain_ms = _time_ms(plain, reps=reps)
    lib_ms = _time_ms(lib, reps=reps) if lib is not None else None
    dev_ms = _device_ms(kern)
    bound, bound_by = _bound_ms(n_bytes, n_ops, dtype)
    print(f"  {name}: {ms:.4f} ms per call, {dev_ms} ms on the device (plain "
          f"{plain_ms:.4f} ms, library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
          f"bound {bound:.5f} ms by {bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib_ms, device_ms=dev_ms, bytes=n_bytes)


def kernel_phase(plan, dev):
    """H0-H3 (float32) against their plain versions on the Rhine path's
    shapes."""
    from pyflwdir_torch import kernels

    rng = np.random.RandomState(SEED)
    n_cells = plan.n_cells
    # integer-valued data with a total below 2^24: the kernels' exact domain
    x = torch.as_tensor(rng.randint(0, 3, n_cells).astype(np.float32), device=dev)
    sig_in = plan.sig_in_t
    c = kernels.accel_in_scan(x, sig_in)
    outp = kernels.accel_near_out(c, plan.near_end_t)
    out = kernels.permute_gather(outp, plan.r_out.sigma)
    far_end = plan.far_end_t
    xpad = torch.zeros(plan.n_pad, dtype=torch.float32, device=dev)
    xpad[:n_cells] = x
    src_perm = plan.r_out.sigma

    fe = far_end.cpu().numpy()
    n_far = int((fe >= 0).sum())
    n_off = int((fe == -2).sum())
    n = plan.n_pad
    f32 = torch.float32
    return {
        "permute_gather": _measure(
            "permute_gather",
            lambda: kernels.permute_gather(outp, src_perm),
            lambda: kernels.permute_gather_plain(outp, src_perm),
            lambda: outp[src_perm], 12 * n, 0, f32),
        "accel_in_scan": _measure(
            "accel_in_scan",
            lambda: kernels.accel_in_scan(x, sig_in),
            lambda: kernels.accel_in_scan_plain(x, sig_in),
            lambda: torch.cumsum(xpad[sig_in], 0), 4 * n + 4 * n_cells + 4 * n, n, f32),
        "accel_near_out": _measure(
            "accel_near_out",
            lambda: kernels.accel_near_out(c, plan.near_end_t),
            lambda: kernels.accel_near_out_plain(c, plan.near_end_t),
            None, 12 * n, n, f32),
        "accel_far_merge": _measure(
            "accel_far_merge",
            lambda: kernels.accel_far_merge(out, x, c, far_end),
            lambda: kernels.accel_far_merge_plain(out, x, c, far_end),
            None,
            # far_end + result per cell, out per tree cell, x per off-tree
            # cell, c per far cell
            8 * n_cells + 4 * (n_cells - n_off) + 4 * n_off + 4 * n_far, n_far, f32),
    }


def tile_kernel_phase(tp, dtype, dev):
    """T1, T2 and the coarse level's H0-H3 in ``dtype`` against their plain
    versions on the tile path's shapes, with the inputs that path gives
    them."""
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
    n_roots, n_ent = tp._coarse_meta["m"], tp._coarse_meta["D"]
    sfx = f".{_DT[dtype]}"
    # bounds count the least bytes each function needs, not the port's
    # int32 layout: slots and lanes of a tile fit 2-byte indices (T =
    # 16,384 < 2^15), a near end 1 byte (its offset from the slot, < 128,
    # or none), and far ends and entries only where a slot has one
    tile_x = kernels._tiles(x.abs(), tp.shape).sum(1)

    exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], tp.shape)
    rows = {"tile_pass_a" + sfx: _measure(
        "tile_pass_a" + sfx,
        lambda: kernels.tile_pass_a(x, t["rin"], t["ex_end"], tp.shape),
        lambda: kernels.tile_pass_a_plain(x, t["rin"], t["ex_end"], tp.shape),
        None,
        # x per cell and rin per slot read, c per slot written; per real
        # local root its end read and its exit written
        s * n + 2 * NT * T + s * NT * T + (2 + s) * n_roots, NT * T + n_roots,
        dtype, (T, float(tile_x.max())), reps=20)}

    # the coarse level on pass A's exits
    co = tp.coarse._t
    xe = exits.reshape(-1)
    n_pad, n_out = co["src_in"].numel(), co["src_out"].numel()
    src_in_np = co["src_in"].cpu().numpy()
    fe = co["far_end"].cpu().numpy()
    n_far, n_off = int((fe >= 0).sum()), int((fe == -2).sum())
    cc = kernels.accel_in_scan(xe, co["src_in"])
    outp = kernels.accel_near_out(cc, co["near_end"])
    out = kernels.permute_gather(outp, co["src_out"])
    xpad = torch.zeros(n_pad + 1, dtype=dtype, device=dev)
    xpad[: xe.numel()] = xe
    n_read = int((src_in_np < xe.numel()).sum())
    csfx = ".coarse" + sfx
    rows["accel_in_scan" + csfx] = _measure(
        "accel_in_scan" + csfx,
        lambda: kernels.accel_in_scan(xe, co["src_in"]),
        lambda: kernels.accel_in_scan_plain(xe, co["src_in"]),
        lambda: torch.cumsum(xpad[co["src_in"]], 0),
        4 * n_pad + s * n_read + s * n_pad, n_pad, dtype, (n_pad, total))
    rows["accel_near_out" + csfx] = _measure(
        "accel_near_out" + csfx,
        lambda: kernels.accel_near_out(cc, co["near_end"]),
        lambda: kernels.accel_near_out_plain(cc, co["near_end"]),
        None, (4 + 2 * s) * n_pad, n_pad, dtype)
    rows["permute_gather" + csfx] = _measure(
        "permute_gather" + csfx,
        lambda: kernels.permute_gather(outp, co["src_out"]),
        lambda: kernels.permute_gather_plain(outp, co["src_out"]),
        lambda: outp[co["src_out"]], (4 + 2 * s) * n_out, 0, dtype)
    rows["accel_far_merge" + csfx] = _measure(
        "accel_far_merge" + csfx,
        lambda: kernels.accel_far_merge(out, None, cc, co["far_end"]),
        lambda: kernels.accel_far_merge_plain(out, None, cc, co["far_end"]),
        None,
        # far_end + result per slot, out per tree slot, c per far slot
        (4 + s) * n_out + s * (n_out - n_off) + s * n_far, n_far, dtype)

    entv = tp.entry_grid(kernels.accel_far_merge(out, None, cc, co["far_end"]))
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
        s * NT * T + NT * T + (s + 2) * n_ent + 4 * n_tfar + 2 * n + s * n_off + s * n,
        2 * NT * T + n_ent + n_tfar, dtype, (E + 3, scale), reps=20)
    return rows


def _rows(rows, counts, path, dtype):
    out = []
    for key, row in rows.items():
        kern = key.split(".")[0]
        if kern in _KERNELS:
            tag, src, replaces = _KERNELS[kern]
            if ".coarse" in key:
                replaces = _COARSE[kern]
        else:
            tag, replaces = _TILE_KERNELS[kern]
            src = _TILE_SRC
        out.append(dict(name=key, tag=tag, route="cuda", source=src, replaces=replaces,
                        launches=counts[kern], path=path, dtype=dtype, **row))
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
    d8 = pyflwdir_torch.fill_depressions(_demo_dem(SHAPE, SEED))[1]
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
    for name in _KERNELS:
        _check(counts[name] > 0, f"{name} launched on the main path")

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
    out = _rows(rows, counts, "rhine 997x682", "float32")
    return out, dict(accumulate_ms=acc_ms, accumulate_device_ms=acc_dev_ms,
                     upstream_area_ms=up_ms, main_path_s=t_main)


def _host_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def tile_path(dev):
    """The 6000x6000 path through TilePlan; returns its kernel rows and
    timings."""
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
    d8 = pyflwdir_torch.fill_depressions(z, nodata=-9999.0)[1]
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
    for name in (*_TILE_KERNELS, *_KERNELS):
        _check(counts_int[name] > 0 and counts_f64[name] > 0,
               f"{name} launched on the main path (int32 and float64)")

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
    # a value sums a tile's prefix (T slots), the coarse level's prefix
    # (n_pad slots) and its tile's entry scan (E_pad), in another order
    # than the sweep
    length = 128 * 128 + co.n_pad + tp.E_pad
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
    acc_dev_ms = _device_ms(lambda: fl._accumulate_dev(ones), reps=5)
    up_ms = _host_ms(fl.upstream_area, 5)
    print(f"  accumulate: median {acc_ms:.4f} ms per call, "
          f"{fl.size / acc_ms / 1e3:.1f} Mgp/s; device busy {acc_dev_ms} ms of it; "
          f"upstream_area() with host copies median {up_ms:.3f} ms")
    out = _rows(rows[torch.int32], counts_int, "tile 6000x6000", "int32")
    out += _rows(rows[torch.float64], counts_f64, "tile 6000x6000", "float64")
    return out, dict(accumulate_ms=acc_ms, accumulate_device_ms=acc_dev_ms,
                     upstream_area_ms=up_ms, main_path_int32_s=t_int,
                     main_path_float64_s=t_f64, fill_s=t_fill, parse_s=t_parse,
                     tile_plan_s=t_plan, tile_plan_steps_s=tp.build_seconds,
                     NT=tp.NT, R_pad=tp.R_pad, E_pad=tp.E_pad, coarse_n_pad=co.n_pad)


def main(json_path=None):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pyflwdir_torch import kernels, runtime

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
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

    rhine_rows, rhine = rhine_path(dev)
    tile_rows, tile = tile_path(dev)

    out = rhine_rows + tile_rows
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(dict(card=smi, rhine=rhine, tile=tile, kernels=out), f, indent=1)
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
