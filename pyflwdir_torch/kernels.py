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
``csrc/accel_kernels.cu`` for float32, int32, int64 and float64:

* ``permute_gather`` (H0) — ``ops/router.py`` ``_ta`` and ``RouterPlan.apply``;
  ``ops/tile_plan.py`` ``_CoarseRouterSmall._route`` (``r_out``)
* ``accel_in_scan`` (H1) — ``ops/accel.py`` ``_accumulate_fused`` k1;
  ``_CoarseRouterSmall._route`` (``r_in``) and the coarse prefix sum
* ``accel_near_out`` (H2) — ``ops/accel.py`` ``_accumulate_fused`` k2;
  ``_CoarseRouterSmall._gather_pair`` (``ops/router_big.py``
  ``lane_gather_tiled``)
* ``accel_far_merge`` (H3) — ``ops/accel.py`` ``_accumulate_fused`` k3 and
  the merge after it; ``_CoarseRouterSmall._far_values`` and its
  ``tree_mask`` select

and in ``csrc/tile_kernels.cu`` for int32, int64 and float64, on 128 x 128
tiles:

* ``tile_pass_a`` (T1) — ``ops/tile_plan.py`` ``TilePlan._pass_a_fused``
* ``tile_pass_c`` (T2) — ``ops/tile_plan.py`` ``TilePlan._pass_c_fused``
* ``tile_down_a`` (T3) — ``ops/tile_plan.py`` ``TilePlan._pass_down_raw``
  and, in routed mode, ``TilePlan._pass_down``
* ``tile_down_fin`` (T4) — ``ops/tile_plan.py`` ``TilePlan._pass_down_fin``
"""

from __future__ import annotations

import ctypes
import glob
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
    "tile_pass_a",
    "tile_pass_a_plain",
    "tile_pass_c",
    "tile_pass_c_plain",
    "tile_down_a",
    "tile_down_a_plain",
    "tile_down_fin",
    "tile_down_fin_plain",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
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
    "tile_pass_a": 0,
    "tile_pass_c": 0,
    "tile_down_a": 0,
    "tile_down_fin": 0,
}

#: element-type codes of the kernels' entry points
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}
_TILE_DTYPES = (torch.int32, torch.int64, torch.float64)
_TILE = 128  # rows and lanes of a tile on the card

_LIBS = {}  # source stem -> loaded library, once
build_seconds = None  # wall time of the nvcc builds in this process, if any


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
        "pf_scan_tile": [],
        "pf_permute_gather": [i32, vp, vp, vp, i64, vp],
        "pf_accel_in_scan": [i32, vp, i64, vp, vp, i64, vp, i64, vp],
        "pf_accel_near_out": [i32, vp, vp, vp, i64, vp],
        "pf_accel_far_merge": [i32, vp, vp, vp, vp, vp, i64, i32, vp],
        "pf_tile_max_smem": [],
        "pf_tile_pass_a": [i32, vp, i64, i64, i64, i64, vp, vp, i64, vp, vp, vp],
        "pf_tile_pass_c": [i32, vp, i64, i64, i64, i64, vp, vp, i64,
                           vp, vp, vp, vp, vp, vp],
        "pf_tile_down_a": [i32, i32, vp, i64, i64, i64, i64, vp, vp, vp, vp, vp,
                           vp, i64, vp, vp, vp, vp],
        "pf_tile_down_fin": [i32, vp, i64, i64, i64, i64, vp, vp, i64, vp, vp, vp, vp],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes


def load():
    """Build (once per source version) and load every kernel library;
    returns ``{source stem: library}``."""
    global build_seconds
    if _LIBS:
        return _LIBS
    srcs = sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))
    flags = " ".join(_NVCC_FLAGS).encode()
    targets = {}
    for src in srcs:
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read() + flags).hexdigest()[:12]
        stem = os.path.splitext(os.path.basename(src))[0]
        targets[stem] = (src, os.path.join(_BUILD_DIR, f"lib{stem}_{tag}.so"))
    todo = {k: v for k, v in targets.items() if not os.path.exists(v[1])}
    if todo:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
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
                os.replace(tmp, so)
        finally:
            for proc, *_ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        build_seconds = time.perf_counter() - t0
    for stem, (_, so) in targets.items():
        lib = ctypes.CDLL(so)
        _bind(lib)
        _LIBS[stem] = lib
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


def _launch(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
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
    ``x.numel()``; the output has ``src``'s shape and ``x``'s dtype."""
    if x.device.type == "cpu":
        return permute_gather_plain(x, src)
    dt = _code("x", x)
    _check("x", x, x.dtype, x.device)
    _check("src", src, torch.int32, x.device)
    out = torch.empty(src.shape, dtype=x.dtype, device=x.device)
    _launch(load()["accel_kernels"].pf_permute_gather, dt, x.data_ptr(),
            src.data_ptr(), out.data_ptr(), src.numel())
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


def accel_in_scan(x, sig_in):
    """Inclusive prefix sum of ``x`` permuted to preorder slots.

    ``x``: (n_cells,) float32, int32, int64 or float64; ``sig_in``: (n_pad,)
    int32 with values in ``[0, n_pad]``, slots whose source is ``>= n_cells``
    read 0. Returns ``c`` (n_pad,) in ``x``'s dtype. The kernel sums in
    another order than the plain version: integers are exact, float32 only
    for integer-valued data with totals below 2^24, float64 within rounding.
    """
    if x.device.type == "cpu":
        return accel_in_scan_plain(x, sig_in)
    dt = _code("x", x)
    _check("x", x, x.dtype, x.device)
    _check("sig_in", sig_in, torch.int32, x.device)
    if x.dim() != 1 or sig_in.dim() != 1 or x.numel() > sig_in.numel():
        raise ValueError("accel_in_scan: need 1-D x no longer than 1-D sig_in")
    lib = load()["accel_kernels"]
    n = sig_in.numel()
    tile = lib.pf_scan_tile()
    n_tiles = max(1, -(-n // tile))
    c = torch.empty(n, dtype=x.dtype, device=x.device)
    tile_sums = torch.empty(n_tiles, dtype=x.dtype, device=x.device)
    _launch(lib.pf_accel_in_scan, dt, x.data_ptr(), x.numel(), sig_in.data_ptr(),
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
    ``-c[k-1]``). ``c``: (n_pad,) float32, int32, int64 or float64;
    ``near_end``: (n_pad,) int32."""
    if c.device.type == "cpu":
        return accel_near_out_plain(c, near_end)
    dt = _code("c", c)
    _check("c", c, c.dtype, c.device)
    _check("near_end", near_end, torch.int32, c.device)
    if near_end.shape != c.shape or c.dim() != 1:
        raise ValueError("accel_near_out: c and near_end must be 1-D of one length")
    outp = torch.empty_like(c)
    _launch(load()["accel_kernels"].pf_accel_near_out, dt, c.data_ptr(),
            near_end.data_ptr(), outp.data_ptr(), c.numel())
    launches["accel_near_out"] += 1
    return outp


# ---------------------------------------------------------------------------
# H3: res = far ? out + c[far_end] : near ? out : (x or 0)
# ---------------------------------------------------------------------------
def accel_far_merge_plain(out, x, c, far_end):
    """Plain version of :func:`accel_far_merge`."""
    n = far_end.numel()
    fe = far_end.long()
    out = out[:n]
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    far = torch.where(fe >= 0, c[fe.clamp(min=0)], zero)
    off = zero if x is None else x
    return torch.where(fe == -2, off, torch.where(fe >= 0, out + far, out))


def accel_far_merge(out, x, c, far_end):
    """Add far-interval ends and pass off-tree cells through.

    ``out``: (>= n_cells,) near result in cell layout; ``far_end``:
    (n_cells,) int32, the slot of a far cell's interval end, -1 for other
    tree cells and -2 off the tree; ``c``: the prefix sums; ``x``: (n_cells,)
    values off-tree cells pass through, or None for 0 there (the tile plan's
    coarse level). float32, int32, int64 or float64, one dtype for all.
    Returns (n_cells,).
    """
    if far_end.device.type == "cpu":
        return accel_far_merge_plain(out, x, c, far_end)
    dev = far_end.device
    dt = _code("c", c)
    for name, t, dtype in (("out", out, c.dtype), ("x", x, c.dtype),
                           ("c", c, c.dtype), ("far_end", far_end, torch.int32)):
        if t is not None:
            _check(name, t, dtype, dev)
    n = far_end.numel()
    if (x is not None and x.numel() != n) or out.numel() < n:
        raise ValueError("accel_far_merge: x must match far_end; out must cover it")
    res = torch.empty(n, dtype=c.dtype, device=dev)
    _launch(load()["accel_kernels"].pf_accel_far_merge, dt, out.data_ptr(),
            None if x is None else x.data_ptr(), c.data_ptr(), far_end.data_ptr(),
            res.data_ptr(), n, int(x is None))
    launches["accel_far_merge"] += 1
    return res


# ---------------------------------------------------------------------------
# tiles of a raster: (H*W,) <-> (NT, 128*128), zero padded past H and W
# ---------------------------------------------------------------------------
def _tiles(x, shape):
    H, W = shape
    S = _TILE
    Hp, Wp = -(-H // S) * S, -(-W // S) * S
    xg = torch.zeros((Hp, Wp), dtype=x.dtype, device=x.device)
    xg[:H, :W] = x.reshape(H, W)
    return xg.reshape(Hp // S, S, Wp // S, S).permute(0, 2, 1, 3).reshape(-1, S * S)


def _untile(xt, shape):
    H, W = shape
    S = _TILE
    Hp, Wp = -(-H // S) * S, -(-W // S) * S
    xg = xt.reshape(Hp // S, Wp // S, S, S).permute(0, 2, 1, 3).reshape(Hp, Wp)
    return xg[:H, :W].reshape(-1)


def _tile_args(shape, rin, x):
    H, W = (int(v) for v in shape)
    NT, T = rin.shape
    ntx = -(-W // _TILE)
    if T != _TILE * _TILE or NT != -(-H // _TILE) * ntx:
        raise ValueError(f"tile tables {tuple(rin.shape)} do not fit 128 x 128 "
                         f"tiles of a {H} x {W} raster")
    if x.numel() != H * W or x.dim() != 1:
        raise ValueError(f"x must be 1-D with {H * W} cells")
    return H, W, NT, ntx


# ---------------------------------------------------------------------------
# T1: per-tile prefix sums in preorder and the local-root exit sums
# ---------------------------------------------------------------------------
def tile_pass_a_plain(x, rin, ex_end, shape):
    """Plain version of :func:`tile_pass_a`."""
    v = torch.gather(_tiles(x, shape), 1, rin.long())
    c = torch.cumsum(v, 1, dtype=x.dtype)
    ce = torch.gather(c, 1, ex_end.long())
    exits = ce - torch.cat([torch.zeros_like(ce[:, :1]), ce[:, :-1]], 1)
    return exits, c


def tile_pass_a(x, rin, ex_end, shape):
    """Pass A of the tile plan (fused): ``x`` (H*W,) raster values, int32,
    int64 or float64; ``rin`` (NT, 16384) int32, the raster cell (within its
    128 x 128 tile, row-major) of each preorder slot; ``ex_end`` (NT, R)
    int32, the preorder end of each local root. Cells past H or W read 0.
    Returns ``(exits (NT, R), c (NT, 16384))``: the local-root subtree sums
    and the tile prefix sums, in ``x``'s dtype."""
    if x.device.type == "cpu":
        return tile_pass_a_plain(x, rin, ex_end, shape)
    dev = x.device
    dt = _code("x", x, _TILE_DTYPES)
    _check("x", x, x.dtype, dev)
    _check("rin", rin, torch.int32, dev)
    _check("ex_end", ex_end, torch.int32, dev)
    H, W, NT, ntx = _tile_args(shape, rin, x)
    if ex_end.dim() != 2 or ex_end.shape[0] != NT or not 0 < ex_end.shape[1] <= rin.shape[1]:
        raise ValueError("ex_end must be (NT, R) with 0 < R <= 16384")
    R = ex_end.shape[1]
    c = torch.empty(rin.shape, dtype=x.dtype, device=dev)
    exits = torch.empty((NT, R), dtype=x.dtype, device=dev)
    _launch(load()["tile_kernels"].pf_tile_pass_a, dt, x.data_ptr(), H, W, NT, ntx,
            rin.data_ptr(), ex_end.data_ptr(), R, c.data_ptr(), exits.data_ptr())
    launches["tile_pass_a"] += 1
    return exits, c


# ---------------------------------------------------------------------------
# T2: entry injection, interval differences, raster order, passthrough
# ---------------------------------------------------------------------------
def tile_pass_c_plain(x, c, entv, ent_idx, near_end, far_end, rout, shape):
    """Plain version of :func:`tile_pass_c`."""
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
    outt = torch.where(r >= 0, torch.gather(outp, 1, r.clamp(min=0)), _tiles(x, shape))
    return _untile(outt, shape)


def tile_pass_c(x, c, entv, ent_idx, near_end, far_end, rout, shape):
    """Pass C of the tile plan (fused), resuming from pass A's ``c``.

    ``x`` (H*W,) raster values; ``c`` (NT, 16384) tile prefix sums; ``entv``
    (NT, E) entry inflows per tile from the coarse level (E may be 0);
    ``ent_idx``, ``near_end``, ``far_end`` (NT, 16384) int32 in preorder
    layout and ``rout`` (NT, 16384) int32 in tile raster layout (see
    ``csrc/tile_kernels.cu``). Returns (H*W,) accumulated values in
    ``x``'s dtype: tree cells get their subtree sum plus their inflow, cells
    off the tree pass ``x`` through."""
    if x.device.type == "cpu":
        return tile_pass_c_plain(x, c, entv, ent_idx, near_end, far_end, rout, shape)
    dev = x.device
    dt = _code("x", x, _TILE_DTYPES)
    for name, t, dtype in (("x", x, x.dtype), ("c", c, x.dtype), ("entv", entv, x.dtype),
                           ("ent_idx", ent_idx, torch.int32),
                           ("near_end", near_end, torch.int32),
                           ("far_end", far_end, torch.int32), ("rout", rout, torch.int32)):
        _check(name, t, dtype, dev)
    H, W, NT, ntx = _tile_args(shape, rout, x)
    for name, t in (("c", c), ("ent_idx", ent_idx), ("near_end", near_end),
                    ("far_end", far_end)):
        if t.shape != rout.shape:
            raise ValueError(f"{name} must be {tuple(rout.shape)}")
    E = entv.shape[1]
    if entv.dim() != 2 or entv.shape[0] != NT:
        raise ValueError("entv must be (NT, E)")
    lib = load()["tile_kernels"]
    if (rout.shape[1] + E) * x.element_size() > lib.pf_tile_max_smem():
        raise ValueError(f"{E} entries per tile in {x.dtype} exceed the shared "
                         "memory of one block")
    out = torch.empty_like(x)
    _launch(lib.pf_tile_pass_c, dt, x.data_ptr(), H, W, NT, ntx, c.data_ptr(),
            entv.data_ptr(), E, ent_idx.data_ptr(), near_end.data_ptr(),
            far_end.data_ptr(), rout.data_ptr(), out.data_ptr())
    launches["tile_pass_c"] += 1
    return out


# ---------------------------------------------------------------------------
# T3: downward pass D1: per-tile path sums to the local roots, entry values
# ---------------------------------------------------------------------------
def _gather0(a, idx):
    """``a[t, idx[t, j]]`` along axis 1, 0 where ``idx < 0``."""
    i = idx.long()
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(i >= 0, torch.gather(a, 1, i.clamp(min=0)), zero)


def tile_down_a_plain(x, rin, es, g_last, g_prev, n_tree, ent_slot, rout, shape,
                      routed):
    """Plain version of :func:`tile_down_a`."""
    xt = _tiles(x, shape)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    on = torch.arange(rin.shape[1], device=x.device)[None, :] < n_tree[:, None]
    u = torch.where(on, torch.gather(xt, 1, rin.long()), zero)
    ues = torch.where(on, torch.gather(xt, 1, es.long()), zero)
    cs = torch.cumsum(ues, 1, dtype=x.dtype)
    g = torch.where(g_last >= 0, _gather0(cs, g_last) - _gather0(cs, g_prev), zero)
    inner = g - torch.cat([u[:, 1:], torch.zeros_like(u[:, :1])], 1)
    z = torch.flip(torch.cumsum(torch.flip(inner, [1]), 1, dtype=x.dtype), [1])
    pk = _gather0(z, ent_slot)
    if routed:
        z = _untile(torch.where(rout >= 0, _gather0(z, rout), xt), shape)
    return z, pk


def tile_down_a(x, rin, es, g_last, g_prev, n_tree, ent_slot, rout, shape, routed):
    """Pass D1 of the tile plan's downward sweep: the sum of ``x`` over the
    path from each tree cell to the root of its tree within the tile.

    ``x`` (H*W,) raster values, int32, int64 or float64; ``rin``, ``es``,
    ``g_last``, ``g_prev`` (NT, 16384) int32 and ``n_tree`` (NT,) int32 (see
    ``csrc/tile_kernels.cu``); ``ent_slot`` (NT, E) int32, the preorder slot
    of each packed entry cell, -1 for padding (E may be 0). Cells past H or
    W read 0. Returns ``(z, pk)``: ``pk`` (NT, E) the path sums at the entry
    cells; ``z`` the path sums, in preorder layout (NT, 16384) or, where
    ``routed``, in raster order (H*W,) through ``rout`` ((NT, 16384) int32 in
    tile raster layout) with cells off the tree passing ``x`` through.
    ``rout`` may be None unless ``routed``."""
    if x.device.type == "cpu":
        return tile_down_a_plain(x, rin, es, g_last, g_prev, n_tree, ent_slot, rout,
                                 shape, routed)
    dev = x.device
    dt = _code("x", x, _TILE_DTYPES)
    _check("x", x, x.dtype, dev)
    tabs = [("rin", rin), ("es", es), ("g_last", g_last), ("g_prev", g_prev)]
    if routed:
        tabs.append(("rout", rout))
    for name, t in (*tabs, ("n_tree", n_tree), ("ent_slot", ent_slot)):
        _check(name, t, torch.int32, dev)
    H, W, NT, ntx = _tile_args(shape, rin, x)
    for name, t in tabs:
        if t.shape != rin.shape:
            raise ValueError(f"{name} must be {tuple(rin.shape)}")
    if n_tree.shape != (NT,):
        raise ValueError("n_tree must be (NT,)")
    if ent_slot.dim() != 2 or ent_slot.shape[0] != NT:
        raise ValueError("ent_slot must be (NT, E)")
    E = ent_slot.shape[1]
    z = torch.empty_like(x) if routed else torch.empty(rin.shape, dtype=x.dtype, device=dev)
    pk = torch.empty((NT, E), dtype=x.dtype, device=dev)
    _launch(load()["tile_kernels"].pf_tile_down_a, dt, int(bool(routed)), x.data_ptr(),
            H, W, NT, ntx, rin.data_ptr(), es.data_ptr(), g_last.data_ptr(),
            g_prev.data_ptr(), n_tree.data_ptr(), ent_slot.data_ptr(), E,
            rout.data_ptr() if routed else None, z.data_ptr(), pk.data_ptr())
    launches["tile_down_a"] += 1
    return z, pk


# ---------------------------------------------------------------------------
# T4: downward pass D2: add the coarse continuation of each tree, raster order
# ---------------------------------------------------------------------------
def tile_down_fin_plain(x, z1, A, tree_of, rout, shape):
    """Plain version of :func:`tile_down_fin`."""
    z = z1 + _gather0(A, tree_of)
    return _untile(torch.where(rout >= 0, _gather0(z, rout), _tiles(x, shape)), shape)


def tile_down_fin(x, z1, A, tree_of, rout, shape):
    """Pass D2 of the tile plan's downward sweep, finishing a raw pass D1.

    ``x`` (H*W,) raster values; ``z1`` (NT, 16384) pass D1's path sums in
    preorder layout; ``A`` (NT, R) the coarse level's path sum below each
    local root; ``tree_of`` (NT, 16384) int32, the local root index of each
    preorder slot, -1 off the tree; ``rout`` (NT, 16384) int32 in tile raster
    layout. Returns (H*W,) in ``x``'s dtype: tree cells get
    ``z1 + A[tree]``, cells off the tree pass ``x`` through."""
    if x.device.type == "cpu":
        return tile_down_fin_plain(x, z1, A, tree_of, rout, shape)
    dev = x.device
    dt = _code("x", x, _TILE_DTYPES)
    for name, t, dtype in (("x", x, x.dtype), ("z1", z1, x.dtype), ("A", A, x.dtype),
                           ("tree_of", tree_of, torch.int32), ("rout", rout, torch.int32)):
        _check(name, t, dtype, dev)
    H, W, NT, ntx = _tile_args(shape, rout, x)
    if z1.shape != rout.shape or tree_of.shape != rout.shape:
        raise ValueError(f"z1 and tree_of must be {tuple(rout.shape)}")
    if A.dim() != 2 or A.shape[0] != NT or A.shape[1] < 1:
        raise ValueError("A must be (NT, R) with R > 0")
    out = torch.empty_like(x)
    _launch(load()["tile_kernels"].pf_tile_down_fin, dt, x.data_ptr(), H, W, NT, ntx,
            z1.data_ptr(), A.data_ptr(), A.shape[1], tree_of.data_ptr(), rout.data_ptr(),
            out.data_ptr())
    launches["tile_down_fin"] += 1
    return out
