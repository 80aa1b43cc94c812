"""Hand-written Hopper kernels of the port: build, load, wrappers, counters.

Every ``csrc/*.cu`` source is compiled at first use with ``nvcc`` for
``sm_90a`` into ``_build/`` (git-ignored; one ``nvcc`` per source, all
started together) and loaded with ctypes; a failed build raises. Each
wrapper below takes tensors:

* on a CUDA tensor it checks device, dtype, shape and contiguity, allocates
  its output with ``torch.empty``, launches the kernel on the current stream,
  raises if the launch failed, and adds one to its entry in
  :data:`launches`;
* on a CPU tensor it runs the plain PyTorch version beside it (``*_plain``),
  which computes the same function. Nothing else falls back to it.

Kernels (and the TPU kernels of the JAX package they replace), in
``csrc/accel_kernels.cu`` for float32, int32, int64 and float64, on arrays
of fewer than 2^31 elements (the plans go up to 2^28 slots):

* ``permute_gather`` (H0) — ``ops/router.py`` ``_ta`` and ``RouterPlan.apply``;
  ``ops/router_big.py`` ``_fused_pass`` (``RouterPlanBig``'s 7-stage chain,
  as ``BigAccelPlan`` runs it for ``r_out`` and downward); ``ops/tile_plan.py``
  ``_CoarseRouterSmall._route`` (``r_out``)
* ``accel_in_scan`` (H1) — ``ops/accel.py`` ``_accumulate_fused`` k1;
  ``_CoarseRouterSmall._route`` (``r_in``) and the coarse prefix sum;
  ``BigAccelPlan``'s ``r_in`` chain (``_fused_pass``) and ``_cumsum``: one
  pass, a look-back over a fixed window of tiles, so the sums run in one
  order from call to call
* ``accel_near_out`` (H2) — ``ops/accel.py`` ``_accumulate_fused`` k2 and
  the far interval ends of k3; ``_gather_pair`` of ``_CoarseRouterSmall``
  and ``BigAccelPlan`` (``ops/router_big.py`` ``lane_gather_tiled``) and the
  far ends of their ``_far_values``: every tree slot's subtree sum, near
  and far, in preorder
* ``accel_far_merge`` (H3), the permute-merge — ``ops/accel.py``
  ``_accumulate_fused``'s ``r_out`` and ``r_far`` routes and the merge after
  k3; the ``r_out`` route, ``_far_values``' ``r_far`` route and the
  ``tree_mask`` select of ``_CoarseRouterSmall`` and ``BigAccelPlan``:
  preorder back to the outputs, off-tree outputs passing ``x`` through or 0

and in ``csrc/tile_kernels.cu`` for int32, int64 and float64 (T3 and T4 also
float32 data, summed in float64 inside), on tiles of
``Y = 128 G`` rows by 128 columns (``G`` 1 to 4, ``T = 16,384 G`` cells):
one 1024-thread block a tile at ``G = 1``, one thread-block cluster of
``G`` blocks a tile above that (T4: ``G`` plain blocks a tile, on a
raster-layout tree table; the same source built once a height:
``csrc/tile_kernels_g2.cu`` to ``_g4.cu`` include it, a library each, all
built at once):

* ``tile_pass_a`` (T1) — ``ops/tile_plan.py`` ``TilePlan._pass_a_fused``
  and, on a tile range, ``_pass_a_tiles_fused``; with ``emit_c=False``
  (counted as ``tile_pass_a_exits``) ``TilePlan._pass_a`` and
  ``_pass_a_tiles``
* ``tile_pass_c`` (T2) — ``ops/tile_plan.py`` ``TilePlan._pass_c_fused``
  and, on a tile range, ``_pass_c_tiles_fused``; with ``c=None`` (full
  mode, counted as ``tile_pass_c_full``) ``TilePlan._pass_c`` and
  ``_pass_c_tiles``
* ``tile_down_a`` (T3) — ``ops/tile_plan.py`` ``TilePlan._pass_down_raw``
  and, in routed mode, ``TilePlan._pass_down`` and, on a tile range,
  ``_pass_down_tiles``
* ``tile_down_fin`` (T4) — ``ops/tile_plan.py`` ``TilePlan._pass_down_fin``;
  in lite mode (``tile_down_lite``, counted apart) ``TilePlan._pass_down_lite``
  and, on a tile range, ``_pass_down_lite_tiles``

The tile height comes from the tables' width ``T``. The tile kernels read
the plan's per-tile tables as int16 on the card where every value of that
height fits (``G`` <= 2) and as int32 above (:func:`tile_table_dtype`; a
wrapper raises TypeError on any other index dtype; ``n_tree`` is int32);
the plain versions take either. Each tile kernel runs on the whole grid
or, given ``tile0``, on the tiles ``tile0 .. tile0 + NT - 1`` (row-major
over the grid; NT the tables' rows), a range that may start and end in the
middle of a tile row: ``x`` is the raster either way, and the raster-side
results come as a tile stack (NT, T), tile raster layout, zero past the
raster's edge. A launch on tiles of ``128 G`` rows (``G > 1``) counts under
its kernel's name with ``_g<G>`` appended (``tile_pass_a_g4``), so a run
shows which ran; :func:`tile_last_cluster` reads the cluster width of a
height's last launch.

and in ``csrc/fill_kernels.cu`` for float32 rasters with a uint8 mask:

* ``fill_sweep`` (F1) — ``ops/fill.py`` ``_sweep_strip``
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess

import torch

from . import trace

__all__ = [
    "launches",
    "reset_launches",
    "load",
    "permute_gather",
    "permute_gather_plain",
    "accel_in_scan",
    "accel_in_scan_chain",
    "accel_in_scan_plain",
    "accel_near_out",
    "accel_near_out_plain",
    "accel_far_merge",
    "accel_far_merge_plain",
    "tile_pass_a",
    "tile_pass_a_plain",
    "tile_pass_c",
    "tile_pass_c_plain",
    "tile_down_a",
    "tile_down_a_plain",
    "tile_down_fin",
    "tile_down_fin_plain",
    "tile_down_lite",
    "tile_down_lite_plain",
    "tile_table_dtype",
    "tile_tree_dtype",
    "tile_last_cluster",
    "fill_sweep",
    "fill_sweep_plain",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_TILE_COUNTS = ("tile_pass_a", "tile_pass_a_exits", "tile_pass_c", "tile_pass_c_full",
                "tile_down_a", "tile_down_fin", "tile_down_lite")
_GS = (1, 2, 3, 4)  # tile heights 128 G the tile kernels take

#: kernel launches per wrapper, counted where the wrapper launches its kernel;
#: a tile kernel's launches on tiles of 128 G rows (G > 1) under ``<name>_g<G>``
launches = {
    "permute_gather": 0,
    "accel_in_scan": 0,
    "accel_near_out": 0,
    "accel_far_merge": 0,
    **{name + ("" if G == 1 else f"_g{G}"): 0 for name in _TILE_COUNTS for G in _GS},
    "fill_sweep": 0,
}

#: element-type codes of the kernels' entry points
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}
_TILE_DTYPES = (torch.int32, torch.int64, torch.float64)
#: the data T3 and T4 take: the tile dtypes, and float32 summed in float64
_DOWN_DTYPES = (torch.float32, *_TILE_DTYPES)
_TILE = 128  # lanes (columns) of a tile, and rows of one block's chunk of it
_CHUNK = _TILE * _TILE  # slots (and cells) one block of a tile kernel holds
#: the library of each tile height's kernels
_TILE_LIB = {1: "tile_kernels", 2: "tile_kernels_g2", 3: "tile_kernels_g3",
             4: "tile_kernels_g4"}

_LIBS = {}  # source stem -> loaded library, once
_H0 = None  # pf_permute_gather, bound at its first launch
_SCAN_GEOM = {}  # dtype -> H1's (threads, slots a thread, window W)
#: wall time of :func:`load` (span ``kernels.load``) where it ran the nvcc builds in
#: this process: the builds, then the libraries loaded; else None
build_seconds = None


def reset_launches():
    """Set every launch count to 0."""
    for k in launches:
        launches[k] = 0


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _bind(lib):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sigs = {
        "pf_permute_gather": [i32, vp, vp, vp, i64, vp],
        "pf_in_scan_geometry": [i32, ctypes.POINTER(ctypes.c_int)],
        "pf_accel_in_scan": [i32, vp, i64, vp, vp, i64, vp, i64, vp],
        "pf_accel_near_out": [i32, vp, vp, vp, i64, vp],
        "pf_accel_far_merge": [i32, vp, vp, vp, vp, i64, vp],
        "pf_tile_max_smem": [],
        # dtype, [mode,] x, H, W, NT, ntx, tile0, [stack,] ...
        "pf_tile_pass_a": [i32, vp, i64, i64, i64, i64, i64, vp, vp, i64, vp, vp, vp],
        "pf_tile_pass_c": [i32, vp, i64, i64, i64, i64, i64, i32, vp, vp, vp, i64,
                           vp, vp, vp, vp, vp, vp],
        "pf_tile_down_a": [i32, i32, vp, i64, i64, i64, i64, i64, i32, vp, vp, vp, vp,
                           vp, vp, i64, vp, vp, vp, vp],
        "pf_tile_down_fin": [i32, i32, vp, i64, i64, i64, i64, i64, i32, vp, vp, i64, vp,
                             i32, vp, vp, vp],
        "pf_tile_last_cluster": [],
        "pf_fill_stage_cols": [],
        "pf_fill_sweep": [vp, vp, vp, vp, vp, i64, i64, i32, i32, vp],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes


def _targets():
    """``{source stem: (source, library path)}``, the path tagged by the
    hash of the flags, the source and the sources it includes from beside it
    (``#include "..."``: ``tile_kernels_g2.cu`` is ``tile_kernels.cu`` for
    another tile height)."""
    flags = " ".join(_NVCC_FLAGS).encode()
    targets = {}
    for src in sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu"))):
        with open(src, "rb") as f:
            text = f.read()
        for inc in re.findall(rb'#include "([^"]+)"', text):
            with open(os.path.join(_SRC_DIR, inc.decode()), "rb") as f:
                text += f.read()
        tag = hashlib.sha256(text + flags).hexdigest()[:12]
        stem = os.path.splitext(os.path.basename(src))[0]
        targets[stem] = (src, os.path.join(_BUILD_DIR, f"lib{stem}_{tag}.so"))
    return targets


def load():
    """Build (once per source version) and load every kernel library;
    returns ``{source stem: library}``."""
    global build_seconds
    if _LIBS:
        return _LIBS
    with trace.timed("kernels.load") as s:
        targets = _targets()
        todo = {k: v for k, v in targets.items() if not os.path.exists(v[1])}
        if todo:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            try:
                for stem, (src, so) in todo.items():
                    tmp = f"{so}.{os.getpid()}.tmp"
                    procs[stem] = (subprocess.Popen(
                        [nvcc, *_NVCC_FLAGS, "-o", tmp, src],
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                    ), tmp, so, src)
                for stem, (proc, tmp, so, src) in procs.items():
                    _, err = proc.communicate(timeout=600)
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc failed on {src}:\n{err}")
                    with open(so + ".ptxas.txt", "w") as f:  # registers and spills
                        f.write(err)
                    os.replace(tmp, so)
            finally:
                for proc, *_ in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
        for stem, (_, so) in targets.items():
            lib = ctypes.CDLL(so)
            _bind(lib)
            _LIBS[stem] = lib
    if todo:
        build_seconds = s.seconds
    return _LIBS


def _check(name, t, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _code(name, t, allowed=tuple(_DTYPE_CODE)):
    if t.dtype not in allowed:
        raise TypeError(f"{name}: dtype {t.dtype} not in {allowed}")
    return _DTYPE_CODE[t.dtype]


def ptxas_report(stem):
    """What ``nvcc -Xptxas -v`` said when it built ``csrc/<stem>.cu``:
    ``{kernel symbol: (registers, spill store bytes, spill load bytes)}``."""
    with open(_targets()[stem][1] + ".ptxas.txt") as f:
        text = f.read()
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            spills = [0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def _launch(fn, *args):
    # the current stream's raw cudaStream_t, read on every launch (the caller
    # may switch streams) without building a torch.cuda.Stream
    err = fn(*args, torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# H0: out[p] = src[p] >= 0 ? x[src[p]] : 0
# ---------------------------------------------------------------------------
def permute_gather_plain(x, src):
    """Plain version of :func:`permute_gather`."""
    i = src.long()
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(i >= 0, x.reshape(-1)[i.clamp(min=0)], zero)


def permute_gather(x, src):
    """``out[p] = x.ravel()[src[p]]``, or 0 where ``src[p] < 0``: ``x``
    float32, int32, int64 or float64, ``src`` int32 with values below
    ``x.numel()``; the output has ``src``'s shape and ``x``'s dtype. ``x``
    and ``src`` hold fewer than 2^31 elements each (held at 2^28).

    The router sweeps call this many times a sweep, so its host path is
    short: the entry bound once, devices compared by index, the raw stream
    read from PyTorch on every call."""
    global _H0
    if x.is_cpu:
        return permute_gather_plain(x, src)
    dt = _DTYPE_CODE.get(x.dtype)
    if dt is None:
        raise TypeError(f"x: dtype {x.dtype} not in {tuple(_DTYPE_CODE)}")
    if src.dtype != torch.int32:
        raise TypeError(f"src: expected torch.int32, got {src.dtype}")
    index = x.get_device()
    if index < 0 or not src.is_cuda or src.get_device() != index:
        raise ValueError(f"x and src must lie on one CUDA device, got {x.device} and "
                         f"{src.device}")
    if not (x.is_contiguous() and src.is_contiguous()):
        raise ValueError("permute_gather: x and src must be contiguous")
    n = src.numel()
    if n >= 1 << 31 or x.numel() >= 1 << 31:
        raise ValueError("permute_gather: x and src must hold fewer than 2^31 elements")
    if _H0 is None:
        _H0 = load()["accel_kernels"].pf_permute_gather
    out = torch.empty_like(src, dtype=x.dtype)
    err = _H0(dt, x.data_ptr(), src.data_ptr(), out.data_ptr(), n,
              torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"pf_permute_gather launch failed: CUDA error {err}")
    launches["permute_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# H1: c = inclusive_scan(xpad[sig_in]), xpad = x padded with zeros
# ---------------------------------------------------------------------------
def accel_in_scan_plain(x, sig_in):
    """Plain version of :func:`accel_in_scan`."""
    n_pad = sig_in.numel()
    xpad = torch.zeros(n_pad + 1, dtype=x.dtype, device=x.device)
    xpad[: x.numel()] = x
    src = sig_in.long().clamp(max=n_pad)  # every source >= n_cells reads 0
    return torch.cumsum(xpad[src], 0, dtype=x.dtype)


def _scan_geometry(dtype):
    """H1's ``(threads, slots a thread, window W in tiles)`` for ``dtype``."""
    geom = _SCAN_GEOM.get(dtype)
    if geom is None:
        out = (ctypes.c_int * 3)()
        if load()["accel_kernels"].pf_in_scan_geometry(_DTYPE_CODE[dtype], out) < 0:
            raise TypeError(f"accel_in_scan: no geometry for {dtype}")
        geom = _SCAN_GEOM[dtype] = tuple(out)
    return geom


def accel_in_scan_chain(n, dtype):
    """The additions on the longest chain of the kernel's prefix sum over
    ``n`` slots of ``dtype`` (``csrc/accel_kernels.cu``, H1): a thread's
    slots, two warp scans of 5 steps, the window's K a lane and 5 more, 2
    for a tile's inclusive prefix, one a hop of the window, and 2 to the
    slot. A float64 result lies within about ``L eps`` times the sum of
    the magnitudes of the exact prefix sum."""
    threads, per, window = _scan_geometry(dtype)
    tiles = max(1, -(-n // (threads * per)))
    return per + window // 32 + 19 + (tiles - 1) // window


def accel_in_scan(x, sig_in):
    """Inclusive prefix sum of ``x`` permuted to preorder slots.

    ``x``: (n_cells,) float32, int32, int64 or float64; ``sig_in``: (n_pad,)
    int32 with values in ``[0, n_pad]``, slots whose source is ``>= n_cells``
    read 0; ``n_pad`` below 2^31. Returns ``c`` (n_pad,) in ``x``'s dtype.
    The kernel sums in another order than the plain version, the same
    order on every call: integers are exact, float32 only for
    integer-valued data with totals below 2^24, float64 within
    :func:`accel_in_scan_chain` roundings.
    """
    if x.device.type == "cpu":
        return accel_in_scan_plain(x, sig_in)
    dt = _code("x", x)
    _check("x", x, x.dtype, x.device)
    _check("sig_in", sig_in, torch.int32, x.device)
    if x.dim() != 1 or sig_in.dim() != 1 or x.numel() > sig_in.numel():
        raise ValueError("accel_in_scan: need 1-D x no longer than 1-D sig_in")
    if sig_in.numel() >= 1 << 31:
        raise ValueError("accel_in_scan: n_pad must stay below 2^31")
    threads, per, _ = _scan_geometry(x.dtype)
    n = sig_in.numel()
    tiles = -(-n // (threads * per))
    # a 16-byte entry a tile for its aggregate and one for its inclusive
    # prefix, then the ticket (pf_accel_in_scan)
    n_bytes = 32 * tiles + 16
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=x.device)
    c = torch.empty(n, dtype=x.dtype, device=x.device)
    _launch(load()["accel_kernels"].pf_accel_in_scan, dt, x.data_ptr(), x.numel(),
            sig_in.data_ptr(), c.data_ptr(), n, scratch.data_ptr(), n_bytes)
    launches["accel_in_scan"] += 1
    return c


# ---------------------------------------------------------------------------
# H2: outp[k] = (end[k] >= 0 ? c[end[k]] : 0) - (k > 0 ? c[k-1] : 0)
# ---------------------------------------------------------------------------
def accel_near_out_plain(c, end):
    """Plain version of :func:`accel_near_out`."""
    ne = end.long()
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    hi = torch.where(ne >= 0, c[ne.clamp(min=0)], zero)
    lo = torch.cat([zero.reshape(1), c[:-1]])
    return hi - lo


def accel_near_out(c, end):
    """Subtree sums in preorder layout, ``c[end[k]] - c[k-1]``: ``end[k]``
    the slot where the interval of the node at slot k ends, near or far,
    -1 where no output reads slot k (it gets ``-c[k-1]``). ``c``: (n_pad,)
    float32, int32, int64 or float64; ``end``: (n_pad,) int32; ``n_pad``
    below 2^31."""
    if c.device.type == "cpu":
        return accel_near_out_plain(c, end)
    dt = _code("c", c)
    _check("c", c, c.dtype, c.device)
    _check("end", end, torch.int32, c.device)
    if end.shape != c.shape or c.dim() != 1:
        raise ValueError("accel_near_out: c and end must be 1-D of one length")
    outp = torch.empty_like(c)
    _launch(load()["accel_kernels"].pf_accel_near_out, dt, c.data_ptr(),
            end.data_ptr(), outp.data_ptr(), c.numel())
    launches["accel_near_out"] += 1
    return outp


# ---------------------------------------------------------------------------
# H3: res[i] = src_res[i] >= 0 ? outp[src_res[i]] : (x[i] or 0)
# ---------------------------------------------------------------------------
def accel_far_merge_plain(outp, x, src_res):
    """Plain version of :func:`accel_far_merge`."""
    i = src_res.long()
    zero = torch.zeros((), dtype=outp.dtype, device=outp.device)
    return torch.where(i >= 0, outp[i.clamp(min=0)], zero if x is None else x)


def accel_far_merge(outp, x, src_res):
    """The permute-merge: preorder subtree sums to the outputs, off-tree
    outputs passing ``x`` through or 0.

    ``outp``: (n_pad,) subtree sums in preorder (:func:`accel_near_out`);
    ``src_res``: (n_out,) int32, the preorder slot of each output, -1 off
    the tree; ``x``: (n_out,) values off-tree outputs pass through, or None
    for 0 there (slot mode). float32, int32, int64 or float64, one dtype for
    both; fewer than 2^31 slots and outputs. Returns (n_out,).
    """
    if src_res.device.type == "cpu":
        return accel_far_merge_plain(outp, x, src_res)
    dev = src_res.device
    dt = _code("outp", outp)
    _check("outp", outp, outp.dtype, dev)
    _check("src_res", src_res, torch.int32, dev)
    if x is not None:
        _check("x", x, outp.dtype, dev)
    n = src_res.numel()
    if (x is not None and x.numel() != n) or n >= 1 << 31 or outp.numel() >= 1 << 31:
        raise ValueError("accel_far_merge: x must match src_res; fewer than 2^31 elements")
    res = torch.empty(n, dtype=outp.dtype, device=dev)
    _launch(load()["accel_kernels"].pf_accel_far_merge, dt, outp.data_ptr(),
            None if x is None else x.data_ptr(), src_res.data_ptr(), res.data_ptr(), n)
    launches["accel_far_merge"] += 1
    return res


# ---------------------------------------------------------------------------
# tiles of a raster: (H*W,) <-> (NT, T), T = Y * 128 cells of a Y x 128 tile,
# zero padded past H and W; a call on tiles tile0 .. tile0 + NT - 1 (tile0
# not None) returns its raster-side results as such a stack of its tiles
# ---------------------------------------------------------------------------
def tile_table_dtype(rows):
    """The index dtype the tile kernels read for tiles of ``rows`` rows:
    int16 where every slot of the tile fits (up to 256 rows: below 32,768),
    else int32."""
    return torch.int16 if int(rows) * _TILE <= 1 << 15 else torch.int32


def tile_tree_dtype(rows, R):
    """The dtype of the tree table T4 reads for tiles of ``rows`` rows whose
    plan has ``R`` (``R_pad``) local roots a tile: at 128 rows ``tree_of``
    in :func:`tile_table_dtype`; above, the raster-layout table
    (``ops.tile_plan.tree_table``), int16 where every tree index fits (``R``
    <= 32,767), else :func:`tile_table_dtype`."""
    return torch.int16 if int(R) <= (1 << 15) - 1 else tile_table_dtype(rows)


def tile_last_cluster(rows):
    """The cluster width of the last launch of a tile kernel of the
    ``rows``-row library (1: a plain grid; 0 before any launch, or where no
    library is loaded), read on the host right after the launch, with no
    synchronisation."""
    if not _LIBS:
        return 0
    return _tile_lib(int(rows) // _TILE).pf_tile_last_cluster()


def _tiles(x, shape, T=_CHUNK):
    H, W = shape
    S, Y = _TILE, T // _TILE
    Hp, Wp = -(-H // Y) * Y, -(-W // S) * S
    xg = torch.zeros((Hp, Wp), dtype=x.dtype, device=x.device)
    xg[:H, :W] = x.reshape(H, W)
    return xg.reshape(Hp // Y, Y, Wp // S, S).permute(0, 2, 1, 3).reshape(-1, T)


def _untile(xt, shape):
    H, W = shape
    S, Y = _TILE, xt.shape[1] // _TILE
    Hp, Wp = -(-H // Y) * Y, -(-W // S) * S
    xg = xt.reshape(Hp // Y, Wp // S, Y, S).permute(0, 2, 1, 3).reshape(Hp, Wp)
    return xg[:H, :W].reshape(-1)


def _xtiles(x, shape, tile0, tab):
    """The tiles of the raster ``x`` a call on the tables ``tab`` (NT, T)
    runs on."""
    xt = _tiles(x, shape, tab.shape[1])
    return xt if tile0 is None else xt[tile0: tile0 + tab.shape[0]]


def _raster_out(outt, shape, tile0):
    """A call's tile results: the raster on the whole grid, else the stack."""
    return _untile(outt, shape) if tile0 is None else outt


def _tile_args(shape, rin, x, tile0=None):
    """``(H, W, NT, ntx, tile0, stack, G)`` of a call whose tables ``rin``
    (or any (NT, T) table) cover the whole grid of ``128 G x 128`` tiles of
    an H x W raster (``T = 16,384 G``, G 1 to 4), or, given ``tile0``, the
    tiles ``tile0 .. tile0 + NT - 1`` of it; ``x``, where given, must be the
    raster."""
    H, W = (int(v) for v in shape)
    NT, T = rin.shape
    G = T // _CHUNK
    if T % _CHUNK or G not in _GS:
        raise ValueError(f"tile tables {tuple(rin.shape)}: a row must hold 16,384 G slots, "
                         "G 1 to 4 (tiles of 128 to 512 rows)")
    Y = G * _TILE
    ntx = -(-W // _TILE)
    n_all = -(-H // Y) * ntx
    fits = NT == n_all if tile0 is None else 0 <= int(tile0) <= n_all - NT
    if not fits:
        where = "" if tile0 is None else f" from tile {tile0}"
        raise ValueError(f"tile tables {tuple(rin.shape)}{where} do not fit the {Y} x 128 "
                         f"tiles of a {H} x {W} raster ({n_all} tiles)")
    if x is not None and (x.numel() != H * W or x.dim() != 1):
        raise ValueError(f"x must be 1-D with {H * W} cells")
    return H, W, NT, ntx, 0 if tile0 is None else int(tile0), int(tile0 is not None), G


def _tile_lib(G):
    return load()[_TILE_LIB[G]]


def _count(name, G):
    launches[name if G == 1 else f"{name}_g{G}"] += 1


def _pairs_aligned(name, t):
    """The kernels read these tables two slots at a time."""
    if t.data_ptr() % (2 * t.element_size()):
        raise ValueError(f"{name} must start on a {2 * t.element_size()}-byte boundary")


# ---------------------------------------------------------------------------
# T1: per-tile prefix sums in preorder and the local-root exit sums
# ---------------------------------------------------------------------------
def _tile_prefix_plain(x, rin, shape, tile0=None):
    """The tile prefix sums in preorder, ``cumsum(x[cell(rin)])`` per tile."""
    v = torch.gather(_xtiles(x, shape, tile0, rin), 1, rin.long())
    return torch.cumsum(v, 1, dtype=x.dtype)


def tile_pass_a_plain(x, rin, ex_end, shape, emit_c=True, tile0=None):
    """Plain version of :func:`tile_pass_a`."""
    c = _tile_prefix_plain(x, rin, shape, tile0)
    ce = torch.gather(c, 1, ex_end.long())
    exits = ce - torch.cat([torch.zeros_like(ce[:, :1]), ce[:, :-1]], 1)
    return (exits, c) if emit_c else exits


def tile_pass_a(x, rin, ex_end, shape, emit_c=True, tile0=None):
    """Pass A of the tile plan: ``x`` (H*W,) raster values, int32, int64 or
    float64; ``rin`` (NT, T) the raster cell (within its ``T / 128`` x 128
    tile, row-major) of each preorder slot, in :func:`tile_table_dtype`;
    ``ex_end`` (NT, R) likewise, the preorder end of each local root. Cells
    past H or W read 0. Returns ``(exits (NT, R), c (NT, T))``: the
    local-root subtree sums and the tile prefix sums, in ``x``'s dtype; with
    ``emit_c=False`` the exits alone (the unfused pass A: no c written or
    allocated). A band of whole tile rows is a raster of its own: its rows,
    and the tables' rows of its tiles. With ``tile0`` the tables cover the
    tiles ``tile0 .. tile0 + NT - 1`` of the raster's grid (a shard of the
    sharded sweep)."""
    if x.device.type == "cpu":
        return tile_pass_a_plain(x, rin, ex_end, shape, emit_c, tile0)
    dev = x.device
    dt = _code("x", x, _TILE_DTYPES)
    _check("x", x, x.dtype, dev)
    H, W, NT, ntx, t0, _, G = _tile_args(shape, rin, x, tile0)
    tab = tile_table_dtype(G * _TILE)
    _check("rin", rin, tab, dev)
    _check("ex_end", ex_end, tab, dev)
    _pairs_aligned("rin", rin)
    if ex_end.dim() != 2 or ex_end.shape[0] != NT or not 0 < ex_end.shape[1] <= rin.shape[1]:
        raise ValueError(f"ex_end must be (NT, R) with 0 < R <= {rin.shape[1]}")
    R = ex_end.shape[1]
    c = torch.empty(rin.shape, dtype=x.dtype, device=dev) if emit_c else None
    exits = torch.empty((NT, R), dtype=x.dtype, device=dev)
    _launch(_tile_lib(G).pf_tile_pass_a, dt, x.data_ptr(), H, W, NT, ntx, t0,
            rin.data_ptr(), ex_end.data_ptr(), R, c.data_ptr() if emit_c else None,
            exits.data_ptr())
    _count("tile_pass_a" if emit_c else "tile_pass_a_exits", G)
    return (exits, c) if emit_c else exits


# ---------------------------------------------------------------------------
# T2: entry injection, interval differences, raster order, passthrough
# ---------------------------------------------------------------------------
def tile_pass_c_plain(x, c, entv, ent_idx, near_end, far_end, rout, shape, rin=None,
                      tile0=None):
    """Plain version of :func:`tile_pass_c`."""
    if c is None:
        c = _tile_prefix_plain(x, rin, shape, tile0)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    if entv.shape[1]:
        pc = torch.cumsum(entv, 1, dtype=entv.dtype)
        ei = ent_idx.long()
        c = c + torch.where(ei >= 0, torch.gather(pc, 1, ei.clamp(min=0)), zero)
    ne, fe = near_end.long(), far_end.long()
    prev = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], 1)
    outp = torch.where(ne >= 0, torch.gather(c, 1, ne.clamp(min=0)), zero) - prev
    outp = outp + torch.where(fe >= 0, torch.gather(c, 1, fe.clamp(min=0)), zero)
    r = rout.long()
    outt = torch.where(r >= 0, torch.gather(outp, 1, r.clamp(min=0)),
                       _xtiles(x, shape, tile0, rout))
    return _raster_out(outt, shape, tile0)


def tile_pass_c(x, c, entv, ent_idx, near_end, far_end, rout, shape, rin=None,
                tile0=None):
    """Pass C of the tile plan, resuming from pass A's ``c`` (fused) or, with
    ``c=None`` (full mode, the unfused pass C), rebuilding it from ``x``
    through ``rin`` as pass A does, with the same bits.

    ``x`` (H*W,) raster values; ``c`` (NT, T) tile prefix sums; ``entv``
    (NT, E) entry inflows per tile from the coarse level (E may be 0);
    ``ent_idx``, ``near_end``, ``far_end`` (NT, T) in preorder layout,
    ``rout`` (NT, T) in tile raster layout and, in full mode, ``rin`` as
    :func:`tile_pass_a` takes it, all in :func:`tile_table_dtype` (see
    ``csrc/tile_kernels.cu``). Returns (H*W,) accumulated values in
    ``x``'s dtype: tree cells get their subtree sum plus their inflow, cells
    off the tree pass ``x`` through; with ``tile0`` (the tables cover tiles
    ``tile0 .. tile0 + NT - 1``) the (NT, T) stack of those tiles."""
    if x.device.type == "cpu":
        return tile_pass_c_plain(x, c, entv, ent_idx, near_end, far_end, rout, shape, rin,
                                 tile0)
    dev = x.device
    dt = _code("x", x, _TILE_DTYPES)
    full = c is None
    if full and rin is None:
        raise ValueError("tile_pass_c: full mode (c=None) needs rin")
    H, W, NT, ntx, t0, stack, G = _tile_args(shape, rout, x, tile0)
    tab = tile_table_dtype(G * _TILE)
    pre = ("rin", rin, tab) if full else ("c", c, x.dtype)
    for name, t, dtype in (("x", x, x.dtype), pre, ("entv", entv, x.dtype),
                           ("ent_idx", ent_idx, tab), ("near_end", near_end, tab),
                           ("far_end", far_end, tab), ("rout", rout, tab)):
        _check(name, t, dtype, dev)
    for name, t in (pre[:2], ("ent_idx", ent_idx), ("near_end", near_end),
                    ("far_end", far_end)):
        if t.shape != rout.shape:
            raise ValueError(f"{name} must be {tuple(rout.shape)}")
    for name, t in (("ent_idx", ent_idx), ("near_end", near_end), ("far_end", far_end),
                    ("rout", rout), ("rin", rin) if full else ("c", c)):
        _pairs_aligned(name, t)
    E = entv.shape[1]
    if entv.dim() != 2 or entv.shape[0] != NT:
        raise ValueError("entv must be (NT, E)")
    lib = _tile_lib(G)
    # each block of a tile holds a 16,384-slot chunk and every entry
    if (_CHUNK + E) * x.element_size() > lib.pf_tile_max_smem():
        raise ValueError(f"{E} entries per tile in {x.dtype} exceed the shared "
                         "memory of one block")
    out = torch.empty(rout.shape if stack else x.shape, dtype=x.dtype, device=dev)
    _launch(lib.pf_tile_pass_c, dt, x.data_ptr(), H, W, NT, ntx, t0, stack,
            None if full else c.data_ptr(), rin.data_ptr() if full else None,
            entv.data_ptr(), E, ent_idx.data_ptr(), near_end.data_ptr(),
            far_end.data_ptr(), rout.data_ptr(), out.data_ptr())
    _count("tile_pass_c_full" if full else "tile_pass_c", G)
    return out


# ---------------------------------------------------------------------------
# T3: downward pass D1: per-tile path sums to the local roots, entry values
# ---------------------------------------------------------------------------
def _gather0(a, idx):
    """``a[t, idx[t, j]]`` along axis 1, 0 where ``idx < 0``."""
    i = idx.long()
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(i >= 0, torch.gather(a, 1, i.clamp(min=0)), zero)


def _sum_dtype(dtype):
    """The dtype T3 and T4 sum data of ``dtype`` in: float64 for float32,
    else ``dtype`` itself."""
    return torch.float64 if dtype == torch.float32 else dtype


def tile_down_a_plain(x, rin, es, g_last, g_prev, n_tree, ent_slot, rout, shape,
                      routed, tile0=None):
    """Plain version of :func:`tile_down_a`."""
    acc = _sum_dtype(x.dtype)
    xt = _xtiles(x.to(acc), shape, tile0, rin)
    zero = torch.zeros((), dtype=acc, device=x.device)
    on = torch.arange(rin.shape[1], device=x.device)[None, :] < n_tree[:, None]
    u = torch.where(on, torch.gather(xt, 1, rin.long()), zero)
    ues = torch.where(on, torch.gather(xt, 1, es.long()), zero)
    cs = torch.cumsum(ues, 1, dtype=acc)
    g = torch.where(g_last >= 0, _gather0(cs, g_last) - _gather0(cs, g_prev), zero)
    inner = g - torch.cat([u[:, 1:], torch.zeros_like(u[:, :1])], 1)
    z = torch.flip(torch.cumsum(torch.flip(inner, [1]), 1, dtype=acc), [1])
    pk = _gather0(z, ent_slot)
    if routed:
        z = _raster_out(torch.where(rout >= 0, _gather0(z, rout), xt), shape, tile0)
        z = z.to(x.dtype)
    return z, pk


def tile_down_a(x, rin, es, g_last, g_prev, n_tree, ent_slot, rout, shape, routed,
                tile0=None):
    """Pass D1 of the tile plan's downward sweep: the sum of ``x`` over the
    path from each tree cell to the root of its tree within the tile.

    ``x`` (H*W,) raster values, int32, int64, float64, or float32 summed in
    float64 (the kernel widens each value as it reads it); ``rin``, ``es``,
    ``g_last``, ``g_prev`` (NT, T) in :func:`tile_table_dtype` and
    ``n_tree`` (NT,) int32 (see ``csrc/tile_kernels.cu``); ``ent_slot``
    (NT, E), the preorder slot of each packed entry cell, -1 for padding (E
    may be 0). Cells past H or W read 0. Returns ``(z, pk)``: ``pk`` (NT, E)
    the path sums at the entry cells; ``z`` the path sums, in preorder
    layout (NT, T) or, where ``routed``, in raster order (H*W,) through
    ``rout`` ((NT, T) in tile raster layout) with cells off the tree passing
    ``x`` through. ``pk`` and preorder ``z`` are in the sums' dtype
    (float64 for float32 data), routed ``z`` in ``x``'s, each sum rounded
    once: float32 data gives the bits of its float64 cast through the
    float64 kernel, cast back. ``rout`` may be None unless ``routed``. With
    ``tile0`` the tables cover the tiles ``tile0 .. tile0 + NT - 1``, and
    routed ``z`` is their (NT, T) stack."""
    if x.device.type == "cpu":
        return tile_down_a_plain(x, rin, es, g_last, g_prev, n_tree, ent_slot, rout,
                                 shape, routed, tile0)
    dev = x.device
    dt = _code("x", x, _DOWN_DTYPES)
    _check("x", x, x.dtype, dev)
    H, W, NT, ntx, t0, stack, G = _tile_args(shape, rin, x, tile0)
    tab = tile_table_dtype(G * _TILE)
    tabs = [("rin", rin), ("es", es), ("g_last", g_last), ("g_prev", g_prev)]
    if routed:
        tabs.append(("rout", rout))
    for name, t in (*tabs, ("ent_slot", ent_slot)):
        _check(name, t, tab, dev)
    _check("n_tree", n_tree, torch.int32, dev)
    for name, t in tabs:
        if t.shape != rin.shape:
            raise ValueError(f"{name} must be {tuple(rin.shape)}")
        _pairs_aligned(name, t)
    if n_tree.shape != (NT,):
        raise ValueError("n_tree must be (NT,)")
    if ent_slot.dim() != 2 or ent_slot.shape[0] != NT:
        raise ValueError("ent_slot must be (NT, E)")
    E = ent_slot.shape[1]
    acc = _sum_dtype(x.dtype)
    z = torch.empty(x.shape if routed and not stack else rin.shape,
                    dtype=x.dtype if routed else acc, device=dev)
    pk = torch.empty((NT, E), dtype=acc, device=dev)
    _launch(_tile_lib(G).pf_tile_down_a, dt, int(bool(routed)), x.data_ptr(),
            H, W, NT, ntx, t0, stack, rin.data_ptr(), es.data_ptr(), g_last.data_ptr(),
            g_prev.data_ptr(), n_tree.data_ptr(), ent_slot.data_ptr(), E,
            rout.data_ptr() if routed else None, z.data_ptr(), pk.data_ptr())
    _count("tile_down_a", G)
    return z, pk


# ---------------------------------------------------------------------------
# T4: downward pass D2: add the coarse continuation of each tree, raster order
# ---------------------------------------------------------------------------
def tile_down_fin_plain(x, z1, A, tree, rout, shape, tile0=None):
    """Plain version of :func:`tile_down_fin`."""
    xt = _xtiles(x.to(z1.dtype), shape, tile0, rout)
    if rout.shape[1] == _CHUNK:  # tree_of, in preorder layout
        z = z1 + _gather0(A, tree)
        out = torch.where(rout >= 0, _gather0(z, rout), xt)
    else:  # the raster-layout tree table of a tall plan
        z = _gather0(z1, rout) + _gather0(A, tree)
        out = torch.where(rout >= 0, z, xt)
    return _raster_out(out, shape, tile0).to(x.dtype)


def tile_down_fin(x, z1, A, tree, rout, shape, tile0=None):
    """Pass D2 of the tile plan's downward sweep, finishing a raw pass D1.

    ``x`` (H*W,) raster values, int32, int64, float64, or float32 summed in
    float64; ``z1`` (NT, T) pass D1's path sums in preorder layout and ``A``
    (NT, R) the coarse level's path sum below each local root, both in the
    sums' dtype (float64 for float32 ``x``); ``rout`` (NT, T) in tile
    raster layout, in :func:`tile_table_dtype`; ``tree`` (NT, T) the plan's tree table in
    :func:`tile_tree_dtype`: at 128 rows ``tree_of``, the local root index
    of each preorder slot (-1 off the tree); on taller tiles the same in
    raster layout, ``tree_of[rout]`` (-1 off the tree; see
    ``ops.tile_plan.tree_table``). Returns (H*W,) in ``x``'s dtype: tree
    cells get ``z1 + A[tree]``, rounded once to float32 for float32 ``x``
    (the bits of the float64 call cast back), cells off the tree pass ``x``
    through; with
    ``tile0`` (the tables cover tiles ``tile0 .. tile0 + NT - 1``) the (NT,
    T) stack of those tiles. Taller tiles launch a plain grid, no cluster."""
    if x.device.type == "cpu":
        return tile_down_fin_plain(x, z1, A, tree, rout, shape, tile0)
    return _tile_down_d2(x, z1, A, tree, rout, shape, tile0, lite=False)


def tile_down_lite_plain(abar, A, tree, rout, shape, tile0=None):
    """Plain version of :func:`tile_down_lite`."""
    at = _tiles(abar, shape, rout.shape[1]) if tile0 is None else abar
    if rout.shape[1] == _CHUNK:  # tree_of, in preorder layout
        r = rout.long()
        tr = torch.gather(tree, 1, r.clamp(min=0)).long()
        on = (r >= 0) & (tr >= 0)
    else:  # the raster-layout tree table of a tall plan
        tr = tree.long()
        on = tr >= 0
    add = torch.gather(A, 1, tr.clamp(min=0))
    return _raster_out(torch.where(on, at + add, at), shape, tile0)


def tile_down_lite(abar, A, tree, rout, shape, tile0=None):
    """Pass D2 of the sharded downward sweep (T4's lite mode): add each
    tree's coarse continuation to the routed pass D1.

    ``abar`` pass D1's routed result (:func:`tile_down_a` with ``routed``):
    the (H*W,) raster or, with ``tile0``, the (NT, T) stack of the tiles
    ``tile0 .. tile0 + NT - 1``; ``A``, ``tree`` and ``rout`` as
    :func:`tile_down_fin` takes them. Returns ``abar``'s layout and dtype:
    ``abar + A[tree]`` on tree cells, ``abar`` elsewhere. Routing is a
    permutation, so this is :func:`tile_down_fin` on the raw pass D1, bit
    for bit."""
    if abar.device.type == "cpu":
        return tile_down_lite_plain(abar, A, tree, rout, shape, tile0)
    return _tile_down_d2(None, abar, A, tree, rout, shape, tile0, lite=True)


def _tile_down_d2(x, z1, A, tree, rout, shape, tile0, lite):
    """Launch T4 in fin mode (``z1`` the raw pass D1) or lite mode (``z1``
    the routed one, ``x`` unused)."""
    dev = z1.device
    dt = _code("z1", z1, _TILE_DTYPES)
    if not lite:  # the data's dtype: float32 sums in float64
        dt = _code("x", x, _DOWN_DTYPES)
        if _sum_dtype(x.dtype) != z1.dtype:
            raise TypeError(f"z1: expected {_sum_dtype(x.dtype)} for x of {x.dtype}, "
                            f"got {z1.dtype}")
    H, W, NT, ntx, t0, stack, G = _tile_args(shape, rout, x, tile0)
    if A.dim() != 2 or A.shape[0] != NT or A.shape[1] < 1:
        raise ValueError("A must be (NT, R) with R > 0")
    tab = tile_table_dtype(G * _TILE)
    tree_dt = tab if G == 1 else tile_tree_dtype(G * _TILE, A.shape[1])
    checks = [("z1", z1, z1.dtype), ("A", A, z1.dtype), ("tree", tree, tree_dt),
              ("rout", rout, tab)]
    if not lite:
        checks.append(("x", x, x.dtype))
    for name, t, dtype in checks:
        _check(name, t, dtype, dev)
    z1_shape = (H * W,) if lite and not stack else rout.shape
    if z1.shape != z1_shape or tree.shape != rout.shape:
        raise ValueError(f"{'abar' if lite else 'z1'} must be {tuple(z1_shape)}, "
                         f"tree {tuple(rout.shape)}")
    if G > 1:  # read two cells at a time
        _pairs_aligned("rout", rout)
        _pairs_aligned("tree", tree)
        if stack and lite:
            _pairs_aligned("abar", z1)
    out = torch.empty(rout.shape if stack else (H * W,), dtype=z1.dtype if lite else x.dtype,
                      device=dev)
    _launch(_tile_lib(G).pf_tile_down_fin, dt, int(lite),
            None if lite else x.data_ptr(), H, W, NT, ntx, t0, stack, z1.data_ptr(),
            A.data_ptr(), A.shape[1], tree.data_ptr(), tree.element_size(), rout.data_ptr(),
            out.data_ptr())
    _count("tile_down_lite" if lite else "tile_down_fin", G)
    return out


# ---------------------------------------------------------------------------
# F1: one row-sequential sweep of reconstruction by erosion
# ---------------------------------------------------------------------------
class _ClampScan:
    """``x(+inf)`` of the inclusive scan of the clamp maps ``x -> max(d[c],
    min(b[c], x))`` along a row of ``n`` columns, west to east (or east to
    west where ``reverse``), by doubling: each column's map composed with the
    one ``s`` columns before it (the JAX package's ``_clamp_combine``, the
    earlier map applied first). Two (a, b) buffers swap between steps; their
    views are made once, so a step is three PyTorch calls."""

    def __init__(self, n, dtype, device):
        bufs = [torch.empty((2, n), dtype=dtype, device=device) for _ in range(2)]
        self.x = bufs[0]
        self.steps = {}
        for reverse in (False, True):
            steps, s, k = [], 1, 0
            while s < n:
                x, y = bufs[k % 2], bufs[(k + 1) % 2]
                if reverse:  # the map s columns east is applied first
                    new, cur, first, keep = y[:, :-s], x[:, :-s], x[:, s:], slice(n - s, n)
                else:
                    new, cur, first, keep = y[:, s:], x[:, s:], x[:, :-s], slice(0, s)
                steps.append((cur[1], first, new, cur[0], new[0], y[:, keep], x[:, keep]))
                s, k = 2 * s, k + 1
            self.steps[reverse] = steps
            self.res = bufs[k % 2]

    def __call__(self, d, b, reverse):
        self.x[0].copy_(d)
        self.x[1].copy_(b)
        for cur_b, first, new, cur_a, new_a, keep_dst, keep_src in self.steps[reverse]:
            # (a, b) = (max(a, min(b, a_first)), min(b, b_first))
            torch.minimum(cur_b, first, out=new)
            torch.maximum(cur_a, new_a, out=new_a)
            keep_dst.copy_(keep_src)
        return torch.maximum(self.res[0], self.res[1])


def fill_sweep_plain(w, dem_eff, fixed, conn8, down):
    """Plain version of :func:`fill_sweep`: a loop over the rows, each a
    pair of clamp scans by doubling."""
    nrow, ncol = w.shape
    out = torch.empty_like(w)
    scan = _ClampScan(ncol, w.dtype, w.device)
    # the previous row's new values between two +inf columns
    prev = torch.full((ncol + 2,), float("inf"), dtype=w.dtype, device=w.device)
    left, mid, right = prev[:-2], prev[1:-1], prev[2:]
    fx = fixed != 0
    for r in range(nrow) if down else range(nrow - 1, -1, -1):
        m_up = torch.minimum(torch.minimum(left, mid), right) if conn8 else mid
        d_row, w_row = dem_eff[r], w[r]
        b = torch.minimum(w_row, m_up)
        new = scan(d_row, b, False)
        new = torch.minimum(new, scan(d_row, torch.minimum(b, new), True))
        torch.where(fx[r], w_row, torch.maximum(new, d_row), out=out[r])
        mid.copy_(out[r])
    return out


def fill_sweep(w, dem_eff, fixed, conn8, down):
    """One raster sweep of reconstruction by erosion: for each row in order
    (top to bottom where ``down``, else bottom to top), ``b = min(w[r],
    m_up)`` with ``m_up`` the minimum of the previous row's new values at
    columns c-1..c+1 (``conn8``) or c, +inf off the grid and before the first
    row; then ``new[c] = max(d[c], min(b[c], new[c-1]))`` west to east,
    the same east to west on ``min(b, new)``, their minimum, at least
    ``d``; ``fixed`` cells keep ``w``. ``w`` and ``dem_eff`` (nrow, ncol)
    float32, NaN-free (nodata is +inf and fixed); ``fixed`` (nrow, ncol)
    uint8. Returns the new ``w``, bitwise equal to the plain version."""
    if w.device.type == "cpu":
        return fill_sweep_plain(w, dem_eff, fixed, conn8, down)
    dev = w.device
    _check("w", w, torch.float32, dev)
    _check("dem_eff", dem_eff, torch.float32, dev)
    _check("fixed", fixed, torch.uint8, dev)
    if w.dim() != 2 or dem_eff.shape != w.shape or fixed.shape != w.shape:
        raise ValueError("fill_sweep: w, dem_eff and fixed must be 2-D of one shape")
    nrow, ncol = w.shape
    if w.numel() >= 1 << 31:
        raise ValueError("fill_sweep: the raster must hold fewer than 2^31 cells")
    lib = load()["fill_kernels"]
    out = torch.empty_like(w)
    # a row of b in device memory, for rows wider than the kernel keeps in
    # registers in one chunk
    scratch = (torch.empty(ncol, dtype=torch.float32, device=dev)
               if ncol > lib.pf_fill_stage_cols() else None)
    _launch(lib.pf_fill_sweep, w.data_ptr(), dem_eff.data_ptr(), fixed.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(), nrow, ncol,
            int(bool(conn8)), int(bool(down)))
    launches["fill_sweep"] += 1
    return out
