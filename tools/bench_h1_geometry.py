"""Time candidate geometries of kernel H1 (``accel_in_scan``) on one NVIDIA GPU.

    python3 tools/bench_h1_geometry.py

Builds ``tools/h1_geometry.cu`` (the kernel source with its template
instantiated at each candidate's threads, slots a thread, window and
blocks an SM) with ``nvcc`` into ``pyflwdir_torch/_build/`` and runs every
candidate on the router plans' own ``src_in``: the Rhine-shape AccelPlan
(997x682, float32) and the 1-D BigAccelPlan of the 6000x6000 seeded DEM
through ``from_dem`` (37,748,736 slots, int32 and float64). For each it
prints whether the result matches the plain version (bitwise; float64
within rtol 1e-12 and 2 * 400 eps total, and the same bits twice), the
median CUDA-event time of one call and the device time of one call from
CUDA events around 20 calls queued back to back. Candidate 0 of each size
is the shipped geometry without its register cap. Needs one CUDA device.
"""

import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import pyflwdir_torch  # noqa: E402
from pyflwdir_torch import kernels  # noqa: E402

# (threads, slots a thread, window tiles a lane, blocks an SM), by value size
CANDIDATES = {
    4: [(512, 16, 2, 1), (512, 16, 1, 1), (512, 16, 4, 1), (256, 16, 2, 1), (512, 8, 2, 1),
        (256, 32, 2, 1), (256, 16, 4, 1), (512, 16, 2, 2), (512, 8, 4, 1), (256, 8, 4, 1),
        (512, 8, 2, 3), (512, 16, 8, 1)],
    8: [(512, 8, 2, 1), (512, 8, 1, 1), (512, 8, 4, 1), (256, 8, 2, 1), (256, 16, 2, 1),
        (512, 4, 4, 1), (256, 16, 4, 1), (512, 8, 2, 2), (512, 8, 8, 1), (256, 8, 4, 1),
        (512, 8, 2, 3), (256, 16, 8, 1)],
}
DT = {torch.float32: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}
_EPS = np.finfo(np.float64).eps


def _build():
    out = os.path.join(ROOT, "pyflwdir_torch", "_build", "libh1_geometry.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    src = os.path.join(ROOT, "tools", "h1_geometry.cu")
    subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hv_in_scan.argtypes = [i32, i32, vp, i64, vp, vp, i64, vp, vp]
    lib.hv_in_scan.restype = i32
    return lib


def _time_ms(fn, reps=30, warmup=5):
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


def _events_ms(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def run(lib, tag, x, src):
    n = src.numel()
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    c = torch.empty(n, dtype=x.dtype, device="cuda")
    want = kernels.accel_in_scan_plain(x, src)
    for v, geom in enumerate(CANDIDATES[x.element_size()]):
        def call():
            err = lib.hv_in_scan(v, DT[x.dtype], x.data_ptr(), x.numel(), src.data_ptr(),
                                 c.data_ptr(), n, scratch.data_ptr(),
                                 torch._C._cuda_getCurrentRawStream(0))
            if err:
                raise RuntimeError(f"candidate {v}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        if x.dtype == torch.float64:
            first = c.clone()
            call()
            torch.cuda.synchronize()
            ok = (torch.allclose(c, want, rtol=1e-12, atol=2 * 400 * _EPS * float(x.sum()))
                  and torch.equal(first.view(torch.int64), c.view(torch.int64)))
        else:
            ok = torch.equal(c, want)
        print(f"{tag} {geom}: ok {ok}, call {_time_ms(call):.4f} ms, "
              f"device {_events_ms(call):.4f} ms", flush=True)


def _dem(shape, seed=7):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape) + np.add.outer(np.linspace(2, 0, shape[0]),
                                           np.linspace(2, 0, shape[1]))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(torch.cuda.get_device_name(0))
    lib = _build()
    rng = np.random.RandomState(1)
    plan = pyflwdir_torch.from_array(pyflwdir_torch.fill_depressions(_dem((997, 682)))[1])._accel()
    x = torch.as_tensor(rng.randint(0, 3, plan.n_cells).astype(np.float32), device="cuda")
    run(lib, "rhine float32", x, plan._t["src_in"])
    fr = pyflwdir_torch.from_dem(_dem((6000, 6000)))
    plan = pyflwdir_torch.Flwdir(fr.idxs_ds, idxs_pit=fr.idxs_pit)._accel()
    for dtype in (torch.int32, torch.float64):
        x = (torch.as_tensor(rng.rand(plan.n_cells), device="cuda") if dtype == torch.float64
             else torch.as_tensor(rng.randint(0, 3, plan.n_cells).astype(np.int32),
                                  device="cuda"))
        run(lib, f"1-D {str(dtype)[6:]}", x, plan._t["src_in"])


if __name__ == "__main__":
    main()
