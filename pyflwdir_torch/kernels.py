"""Hand-written Hopper kernels of the port: build, load, wrappers, counters.

``csrc/accel_kernels.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into ``_build/`` (git-ignored) and loaded with ctypes. Each
wrapper below takes tensors:

* on a CUDA tensor it checks device, dtype, shape and contiguity, allocates
  its output with ``torch.empty``, launches the kernel on the current stream,
  raises if the launch failed, and adds one to its entry in
  :data:`launches`;
* on a CPU tensor it runs the plain PyTorch version beside it (``*_plain``),
  which computes the same function. Nothing else falls back to it.

Kernels (and the TPU kernels of the JAX package they replace):

* ``permute_gather`` (H0) — ``ops/router.py`` ``_ta`` and ``RouterPlan.apply``
* ``accel_in_scan`` (H1) — ``ops/accel.py`` ``_accumulate_fused`` k1
* ``accel_near_out`` (H2) — ``ops/accel.py`` ``_accumulate_fused`` k2
* ``accel_far_merge`` (H3) — ``ops/accel.py`` ``_accumulate_fused`` k3 and
  the merge after it
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

__all__ = [
    "launches",
    "reset_launches",
    "load",
    "permute_gather",
    "permute_gather_plain",
    "accel_in_scan",
    "accel_in_scan_plain",
    "accel_near_out",
    "accel_near_out_plain",
    "accel_far_merge",
    "accel_far_merge_plain",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "accel_kernels.cu")
_BUILD_DIR = os.path.join(_HERE, "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

#: kernel launches per wrapper, counted where the wrapper launches its kernel
launches = {
    "permute_gather": 0,
    "accel_in_scan": 0,
    "accel_near_out": 0,
    "accel_far_merge": 0,
}

_LIB = []  # the loaded library, once
build_seconds = None  # wall time of the nvcc build in this process, if any


def reset_launches():
    """Set every launch count to 0."""
    for k in launches:
        launches[k] = 0


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load():
    """Build (once per source version) and load the kernel library."""
    global build_seconds
    if _LIB:
        return _LIB[0]
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"libaccel_kernels_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        res = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC],
            capture_output=True, text=True, timeout=600,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stderr}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.pf_scan_tile.restype = ctypes.c_int
    lib.pf_scan_tile.argtypes = []
    lib.pf_permute_gather.restype = ctypes.c_int
    lib.pf_permute_gather.argtypes = [vp, vp, vp, i64, vp]
    lib.pf_accel_in_scan.restype = ctypes.c_int
    lib.pf_accel_in_scan.argtypes = [vp, i64, vp, vp, i64, vp, i64, vp]
    lib.pf_accel_near_out.restype = ctypes.c_int
    lib.pf_accel_near_out.argtypes = [vp, vp, vp, i64, vp]
    lib.pf_accel_far_merge.restype = ctypes.c_int
    lib.pf_accel_far_merge.argtypes = [vp, vp, vp, vp, vp, i64, vp]
    _LIB.append(lib)
    return lib


def _check(name, t, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launch(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# H0: out[p] = x[src[p]]
# ---------------------------------------------------------------------------
def permute_gather_plain(x, src):
    """Plain version of :func:`permute_gather`."""
    return x.reshape(-1)[src.long()].reshape(src.shape)


def permute_gather(x, src):
    """``out[p] = x.ravel()[src[p]]``: float32 ``x``, int32 ``src`` with
    values in ``[0, x.numel())``; the output has ``src``'s shape."""
    if x.device.type == "cpu":
        return permute_gather_plain(x, src)
    _check("x", x, torch.float32, x.device)
    _check("src", src, torch.int32, x.device)
    out = torch.empty(src.shape, dtype=torch.float32, device=x.device)
    _launch(load().pf_permute_gather, x.data_ptr(), src.data_ptr(), out.data_ptr(),
            src.numel())
    launches["permute_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# H1: c = inclusive_scan(xpad[sig_in]), xpad = x padded with zeros
# ---------------------------------------------------------------------------
def accel_in_scan_plain(x, sig_in):
    """Plain version of :func:`accel_in_scan`."""
    n_pad = sig_in.numel()
    xpad = torch.zeros(n_pad, dtype=x.dtype, device=x.device)
    xpad[: x.numel()] = x
    return torch.cumsum(xpad[sig_in.long()], 0)


def accel_in_scan(x, sig_in):
    """Inclusive prefix sum of ``x`` permuted to preorder slots.

    ``x``: (n_cells,) float32; ``sig_in``: (n_pad,) int32 bijection on
    ``[0, n_pad)``, slots whose source is ``>= n_cells`` read 0. Returns
    ``c`` (n_pad,) float32. Exact for integer-valued data with totals below
    2^24 only: the kernel sums in another order than the plain version.
    """
    if x.device.type == "cpu":
        return accel_in_scan_plain(x, sig_in)
    _check("x", x, torch.float32, x.device)
    _check("sig_in", sig_in, torch.int32, x.device)
    if x.dim() != 1 or sig_in.dim() != 1 or x.numel() > sig_in.numel():
        raise ValueError("accel_in_scan: need 1-D x no longer than 1-D sig_in")
    lib = load()
    n = sig_in.numel()
    tile = lib.pf_scan_tile()
    n_tiles = max(1, -(-n // tile))
    c = torch.empty(n, dtype=torch.float32, device=x.device)
    tile_sums = torch.empty(n_tiles, dtype=torch.float32, device=x.device)
    _launch(lib.pf_accel_in_scan, x.data_ptr(), x.numel(), sig_in.data_ptr(),
            c.data_ptr(), n, tile_sums.data_ptr(), n_tiles)
    launches["accel_in_scan"] += 1
    return c


# ---------------------------------------------------------------------------
# H2: outp[k] = (near_end[k] >= 0 ? c[near_end[k]] : 0) - (k > 0 ? c[k-1] : 0)
# ---------------------------------------------------------------------------
def accel_near_out_plain(c, near_end):
    """Plain version of :func:`accel_near_out`."""
    ne = near_end.long()
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    hi = torch.where(ne >= 0, c[ne.clamp(min=0)], zero)
    lo = torch.cat([zero.reshape(1), c[:-1]])
    return hi - lo


def accel_near_out(c, near_end):
    """Near-interval subtree sums in preorder layout (far slots get
    ``-c[k-1]``). ``c``, ``near_end``: (n_pad,) float32 / int32."""
    if c.device.type == "cpu":
        return accel_near_out_plain(c, near_end)
    _check("c", c, torch.float32, c.device)
    _check("near_end", near_end, torch.int32, c.device)
    if near_end.shape != c.shape or c.dim() != 1:
        raise ValueError("accel_near_out: c and near_end must be 1-D of one length")
    outp = torch.empty_like(c)
    _launch(load().pf_accel_near_out, c.data_ptr(), near_end.data_ptr(),
            outp.data_ptr(), c.numel())
    launches["accel_near_out"] += 1
    return outp


# ---------------------------------------------------------------------------
# H3: res = far ? out + c[far_end] : near ? out : x
# ---------------------------------------------------------------------------
def accel_far_merge_plain(out, x, c, far_end):
    """Plain version of :func:`accel_far_merge`."""
    n = x.numel()
    fe = far_end.long()
    out = out[:n]
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    far = torch.where(fe >= 0, c[fe.clamp(min=0)], zero)
    return torch.where(fe == -2, x, torch.where(fe >= 0, out + far, out))


def accel_far_merge(out, x, c, far_end):
    """Add far-interval ends and pass off-tree cells through.

    ``out``: (>= n_cells,) float32 cell-layout near result; ``x``, ``far_end``:
    (n_cells,) float32 / int32 with ``far_end`` the slot of a far cell's
    interval end, -1 for other tree cells and -2 off-tree; ``c``: the prefix
    sums. Returns (n_cells,) float32.
    """
    if x.device.type == "cpu":
        return accel_far_merge_plain(out, x, c, far_end)
    dev = x.device
    for name, t, dt in (("out", out, torch.float32), ("x", x, torch.float32),
                        ("c", c, torch.float32), ("far_end", far_end, torch.int32)):
        _check(name, t, dt, dev)
    n = x.numel()
    if far_end.numel() != n or out.numel() < n:
        raise ValueError("accel_far_merge: far_end must match x; out must cover it")
    res = torch.empty_like(x)
    _launch(load().pf_accel_far_merge, out.data_ptr(), x.data_ptr(), c.data_ptr(),
            far_end.data_ptr(), res.data_ptr(), n)
    launches["accel_far_merge"] += 1
    return res
