"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root:  python3 chip_smoke.py [--json PATH]
(``--json`` also writes the measurements to PATH).

1. Prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels (nvcc, sm_90a) and the native host library from the sources.
2. Kernel phase: each hand-written kernel (H0-H3) against its plain PyTorch
   version on the card, at the shapes the main path gives it, bitwise; times
   each (median of CUDA-event timings after warm-up) beside its plain
   version, one PyTorch library call where there is one, and its bound.
3. Main path: a 997x682 grid (the Rhine raster's shape) from a seeded DEM,
   fill_depressions -> from_array -> upstream_area (cells, km2),
   accuflux, rank and roots on the card. Checks the launch counters, the
   sequential native oracle, mass conservation and a CPU run of the port.
4. Prints a JSON line of the kernels, then {"ok": true, "device": ...}.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SHAPE = (997, 682)  # the Rhine D8 raster's shape
SEED = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
LATLON = (1 / 120, 0.0, 5.0, 0.0, -1 / 120, 52.0)  # 30 arcsec, near the Rhine

_KERNELS = {
    # file:line of the TPU kernel, inside the JAX package
    "permute_gather": ("H0", "ops/router.py:153 (_ta), ops/router.py:320 (RouterPlan.apply)"),
    "accel_in_scan": ("H1", "ops/accel.py:200 (_accumulate_fused k1, pallas_call :226)"),
    "accel_near_out": ("H2", "ops/accel.py:200 (_accumulate_fused k2, pallas_call :251)"),
    "accel_far_merge": ("H3", "ops/accel.py:200 (_accumulate_fused k3, pallas_call :282)"),
}
_SOURCE = "pyflwdir_torch/csrc/accel_kernels.cu"


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


def _device_ms(fn, reps=20):
    """Device time of one call: the sum of its kernels' durations in a
    torch.profiler trace (CUPTI), None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / reps / 1e3 if total_us > 0 else None


def _bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
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


def kernel_phase(plan, dev):
    """Each kernel against its plain version on the main path's shapes."""
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
    cases = {
        "permute_gather": (
            lambda: kernels.permute_gather(outp, src_perm),
            lambda: kernels.permute_gather_plain(outp, src_perm),
            lambda: outp[src_perm],
            (12 * n, 0),
        ),
        "accel_in_scan": (
            lambda: kernels.accel_in_scan(x, sig_in),
            lambda: kernels.accel_in_scan_plain(x, sig_in),
            lambda: torch.cumsum(xpad[sig_in], 0),
            (4 * n + 4 * n_cells + 4 * n, n),
        ),
        "accel_near_out": (
            lambda: kernels.accel_near_out(c, plan.near_end_t),
            lambda: kernels.accel_near_out_plain(c, plan.near_end_t),
            None,
            (12 * n, n),
        ),
        "accel_far_merge": (
            lambda: kernels.accel_far_merge(out, x, c, far_end),
            lambda: kernels.accel_far_merge_plain(out, x, c, far_end),
            None,
            # far_end + result per cell, out per tree cell, x per off-tree
            # cell, c per far cell
            (8 * n_cells + 4 * (n_cells - n_off) + 4 * n_off + 4 * n_far, n_far),
        ),
    }
    rows = {}
    for name, (kern, plain, lib, (n_bytes, n_ops)) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        _check(torch.equal(got, want), f"{name} bitwise equal to its plain version")
        ms = _time_ms(kern)
        plain_ms = _time_ms(plain)
        lib_ms = _time_ms(lib) if lib is not None else None
        dev_ms = _device_ms(kern)
        bound, bound_by = _bound_ms(n_bytes, n_ops)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=bound_by, library_ms=lib_ms, device_ms=dev_ms,
                          bytes=n_bytes)
        print(f"  {name}: {ms:.4f} ms per call, {dev_ms} ms on the device (plain "
              f"{plain_ms:.4f} ms, library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
              f"bound {bound:.5f} ms by {bound_by})")
    return rows


def main(json_path=None):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import pyflwdir_torch
    from pyflwdir_torch import kernels, runtime
    from pyflwdir_torch.ops import graph
    from pyflwdir_torch.ops.accel import AccelPlan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    kernels.load()
    runtime._lib()
    print(f"build: kernels and host library ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'} s)")

    # -- the grid, the raster, the plan ---------------------------------
    t0 = time.perf_counter()
    d8 = pyflwdir_torch.fill_depressions(_demo_dem(SHAPE, SEED))[1]
    fl = pyflwdir_torch.from_array(d8, transform=LATLON, latlon=True)
    plan = fl._accel()
    print(f"setup: fill + parse + plans {time.perf_counter() - t0:.2f} s; "
          f"{fl.size} cells, n_pad {plan.n_pad}, G {plan.G}, b {plan.b}")
    _check(isinstance(plan, AccelPlan) and plan.has_far,
           "main path takes the AccelPlan, with far intervals")

    print("kernel phase:")
    rows = kernel_phase(plan, dev)

    # -- main path --------------------------------------------------------
    print("main path:")
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

    # -- results ---------------------------------------------------------
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
    # float64 prefix sums in another order on the card than on the CPU: an
    # interval difference keeps the prefix sum's absolute error, bounded by
    # n * eps * total for any summation order, on each side
    eps = np.finfo(np.float64).eps
    km2_cpu = cpu.upstream_area("km2")
    total = float(km2_cpu.ravel()[fl.idxs_pit].sum())
    diff = float(np.abs(upa_km2 - km2_cpu).max())
    print(f"  km2: max |card - cpu| {diff:.3e} = {diff / (eps * total):.1f} eps * total")
    _check(np.allclose(upa_km2, km2_cpu, rtol=1e-12, atol=2 * fl.size * eps * total),
           "upstream_area('km2') within rtol 1e-12, atol 2 n eps total of the CPU run")
    acc_cpu = cpu.accuflux(fdata)
    diff = float(np.abs(acc - acc_cpu).max())
    print(f"  accuflux: max |card - cpu| {diff:.3e} = {diff / (eps * fdata.sum()):.1f} eps * total")
    _check(np.allclose(acc, acc_cpu, rtol=1e-12, atol=2 * fl.size * eps * fdata.sum()),
           "accuflux(float64) within rtol 1e-12, atol 2 n eps total of the CPU run")
    _check(np.array_equal(rnk, cpu.rank), "rank equal to the CPU run")
    roots_cpu = graph.roots(cpu._ds).numpy()
    _check(np.array_equal(roots, roots_cpu), "roots equal to the CPU run")

    # -- throughput of the accumulation call -----------------------------
    ones = torch.ones(fl.size, dtype=torch.int32, device=dev)
    acc_ms = _time_ms(lambda: fl._accumulate_dev(ones), reps=100, warmup=10)
    acc_dev_ms = _device_ms(lambda: fl._accumulate_dev(ones))
    t_host = []
    for _ in range(10):
        t0 = time.perf_counter()
        fl.upstream_area()
        t_host.append(time.perf_counter() - t0)
    up_ms = statistics.median(t_host) * 1e3
    print(f"accumulate ({smi}): median {acc_ms:.4f} ms per call, "
          f"{fl.size / acc_ms / 1e3:.1f} Mgp/s; device busy {acc_dev_ms} ms of it; "
          f"upstream_area() with host copies median {up_ms:.3f} ms")

    out = []
    for name, (tag, replaces) in _KERNELS.items():
        out.append(dict(name=name, tag=tag, route="cuda", source=_SOURCE, replaces=replaces,
                        launches=counts[name], **rows[name]))
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(dict(card=smi, accumulate_ms=acc_ms, accumulate_device_ms=acc_dev_ms,
                           upstream_area_ms=up_ms, main_path_s=t_main, kernels=out),
                      f, indent=1)
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
