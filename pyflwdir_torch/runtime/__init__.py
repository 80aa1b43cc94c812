"""ctypes binding of the shared native host library ``csrc/libpyflwdir_host.so``.

Binds only what the port uses so far: the priority-flood depression fill,
the DFS preorder, the LUT flow-direction parser, the bipartite edge
colouring and the TPU router tables of the JAX plan build, the sequential
accumulation sweeps upward and downward (the oracles the device paths are
held against), the tile plan's per-tile DFS, bijection padding and
downward sort phase, the Strahler and classic stream-order sweeps, the
stream segments, the river-length smoothing, the area sub-basin
outlets, the batched walks (paths and snapping), the Dijkstra spread of
the nearest observation, the channel walks between outlet pixels and the
fixed-length windows of the sub-grid statistics, the streamline profile
repairs (elevation adjustment, D4 digging) and the IHU upscaling repairs.
The library is
git-ignored; at first use it is built with ``make -C csrc``, and a failed
build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

from .. import trace

__all__ = [
    "priority_flood",
    "dfs_preorder",
    "flw_from_array_lut",
    "accuflux_sweep",
    "tile_plan_phase1",
    "tile_pad_bijection",
    "tile_down_phase",
    "tile_fwd_tables",
    "tile_inv_rows",
    "bipartite_color",
    "downward_sweep",
    "strahler_order",
    "classic_order",
    "stream_segments",
    "smooth_rivlen",
    "subbasin_area_outlets",
    "trace_walks",
    "spread2d",
    "channel_paths",
    "fixed_windows",
    "adjust_elevation",
    "repair_profile",
    "dig_d4",
    "ihu_relocate",
    "ihu_opt_rivlen",
    "ihu_min_error",
]

_CSRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "csrc"))
_LIB_PATH = os.path.join(_CSRC, "libpyflwdir_host.so")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F64P = ctypes.POINTER(ctypes.c_double)
_U32P = ctypes.POINTER(ctypes.c_uint32)

_LIB = []  # the loaded library, once


def _native(fn):
    """``fn``, a call into the library, under the span ``native.<name>``."""
    name = "native." + fn.__name__

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with trace.span(name):
            return fn(*args, **kwargs)

    return call


def _lib():
    """The loaded library, built on first use."""
    if _LIB:
        return _LIB[0]
    if not os.path.exists(_LIB_PATH):
        res = subprocess.run(
            ["make", "-C", _CSRC], capture_output=True, text=True, timeout=300
        )
        if res.returncode != 0:
            raise RuntimeError(f"building {_LIB_PATH} failed:\n{res.stderr}")
    lib = ctypes.CDLL(_LIB_PATH)
    lib.priority_flood.restype = None
    lib.priority_flood.argtypes = [
        _F64P, _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, _I64P, ctypes.c_int64,
    ]
    lib.accuflux_sweep.restype = None
    lib.accuflux_sweep.argtypes = [_I64P, _I64P, ctypes.c_int64, _F64P]
    lib.dfs_preorder.restype = ctypes.c_int64
    lib.dfs_preorder.argtypes = [_I64P, ctypes.c_int64, _I64P, _I64P, _I64P]
    lib.flw_from_array_lut.restype = None
    lib.flw_from_array_lut.argtypes = [
        _U8P, _I8P, _I8P, ctypes.c_uint8, ctypes.c_int64, ctypes.c_int64,
        _I32P, _I64P, _I64P,
    ]
    lib.flw_collect_pits.restype = None
    lib.flw_collect_pits.argtypes = [_I32P, ctypes.c_int64, _I32P]
    lib.tp_phase1.restype = ctypes.c_void_p
    lib.tp_phase1.argtypes = [
        _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I32P, _I8P, _I8P, _I8P, _I8P, _I32P, _I32P,
        _I64P, _I64P, _I64P, _I64P, _I64P,
    ]
    lib.tp_phase1_export.restype = None
    lib.tp_phase1_export.argtypes = [ctypes.c_void_p, _I64P, _I32P, _I32P, _I32P]
    lib.tp_pad_bijection.restype = None
    lib.tp_pad_bijection.argtypes = [
        _I64P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I32P,
    ]
    lib.tp_down_phase.restype = None
    lib.tp_down_phase.argtypes = [
        _I8P, _I8P, _I8P, _I32P, _I64P, _I32P, _I32P, ctypes.c_int64,
        ctypes.c_int64, _I32P, _I32P, _I32P, _I8P, _I8P,
    ]
    lib.tp_fwd_tables.restype = None
    lib.tp_fwd_tables.argtypes = [
        _I32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I8P, _I8P, _I8P, _I8P, ctypes.c_void_p,
    ]
    lib.tp_inv_rows.restype = None
    lib.tp_inv_rows.argtypes = [_I8P, ctypes.c_int64, ctypes.c_int64, _I8P]
    lib.bipartite_color.restype = None
    lib.bipartite_color.argtypes = [
        _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, _I32P,
    ]
    lib.downward_sweep.restype = None
    lib.downward_sweep.argtypes = [_I64P, _I64P, ctypes.c_int64, _F64P, _F64P]
    lib.strahler_order_host.restype = None
    lib.strahler_order_host.argtypes = [
        _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, _U8P,
    ]
    lib.classic_order_host.restype = None
    lib.classic_order_host.argtypes = [
        _I64P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, _I8P,
        _U8P,
    ]
    for name in ("stream_segments_count", "stream_segments_fill"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [
            _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, _I32P,
            ctypes.c_int64, _I64P, _I64P,
        ]
    lib.smooth_rivlen_host.restype = None
    lib.smooth_rivlen_host.argtypes = [
        _I64P, _I64P, ctypes.c_int64, _F64P, ctypes.c_double, ctypes.c_int64,
        ctypes.c_double,
    ]
    lib.subbasin_area_outlets.restype = ctypes.c_int64
    lib.subbasin_area_outlets.argtypes = [
        _I64P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, _F64P, ctypes.c_double,
        _U32P, _I64P,
    ]
    for name in ("trace_walks_count", "trace_walks_fill"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [
            _I64P, ctypes.c_int64, _I64P, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
            _I64P, ctypes.c_void_p,
        ]
    lib.spread2d.restype = None
    lib.spread2d.argtypes = [
        _F64P, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double, _F64P, _I32P, ctypes.POINTER(ctypes.c_float),
    ]
    lib.ucat_paths_count.restype = None
    lib.ucat_paths_count.argtypes = [
        _I64P, ctypes.c_int64, _I64P, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, _I64P, _I64P, _I8P,
    ]
    lib.ucat_paths_fill.restype = None
    lib.ucat_paths_fill.argtypes = [_I64P, ctypes.c_int64, _I64P, ctypes.c_int64, _I64P, _I64P]
    lib.fixed_window_count.restype = None
    lib.fixed_window_count.argtypes = [
        _I64P, _I64P, _F64P, ctypes.c_void_p, _I64P, ctypes.c_int64, ctypes.c_double,
        _I64P, _I64P,
    ]
    lib.fixed_window_fill.restype = None
    lib.fixed_window_fill.argtypes = [_I64P, _I64P, ctypes.c_int64, _I64P, _I64P]
    lib.adjust_elevation_host.restype = None
    lib.adjust_elevation_host.argtypes = [_I64P, _I64P, ctypes.c_int64, ctypes.c_int64, _F64P]
    lib.repair_profile_host.restype = None
    lib.repair_profile_host.argtypes = [_F64P, ctypes.c_int64]
    lib.dig_d4_host.restype = None
    lib.dig_d4_host.argtypes = [
        _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, _F64P, ctypes.c_double, ctypes.c_double,
    ]
    dims = [ctypes.c_int64] * 6  # nlow, nsub, nrow, ncol, subncol, cellsize
    lib.ihu_relocate.restype = ctypes.c_int64
    lib.ihu_relocate.argtypes = [_I64P, _I64P, _I64P, _F64P, *dims, _I64P, ctypes.c_int64,
                                 _I64P]
    lib.ihu_opt_rivlen.restype = None
    lib.ihu_opt_rivlen.argtypes = [
        _I64P, _I64P, _I32P, _U8P, _I64P, _F64P, *dims, _I64P, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.ihu_min_error.restype = None
    lib.ihu_min_error.argtypes = [
        _I64P, _I64P, _I32P, _U8P, _I64P, _F64P, *dims, _I64P, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,
    ]
    _LIB.append(lib)
    return lib


@_native
def priority_flood(
    elevtn,
    outlets="edge",
    idxs_pit=None,
    nodata=-9999.0,
    max_depth=-1.0,
    elv_max=None,
    connectivity=8,
):
    """Wang & Liu (2006) priority-flood fill and D8 derivation
    (``csrc/host_kernels.cpp::priority_flood``). Returns ``(filled, d8)``."""
    from ..dem import get_edge

    elevtn = np.asarray(elevtn)
    nrow, ncol = elevtn.shape
    work = np.ascontiguousarray(elevtn, dtype=np.float64).copy()
    d8 = np.zeros((nrow, ncol), dtype=np.uint8)
    nan = isinstance(nodata, float) and np.isnan(nodata)
    done = np.isnan(elevtn) if nan else elevtn == nodata
    if connectivity not in (4, 8):
        raise ValueError('"connectivity" should either be 4 or 8')
    struct = np.ones((3, 3), dtype=bool)
    if connectivity == 4:
        struct[0, 0] = struct[-1, -1] = struct[0, -1] = struct[-1, 0] = False
    if idxs_pit is None:
        queued = get_edge(~done, structure=struct)
        if elv_max is not None:
            queued = np.logical_and(queued, elevtn <= elv_max)
            if not np.any(queued):
                raise ValueError("No initial outlet cells found.")
        seeds = np.where(queued.ravel())[0].astype(np.int64)
        if outlets == "min":
            # single outlet: lowest edge cell, (z32, r, c) tie-break
            zb = work.ravel()[seeds].astype(np.float32)
            rr = (seeds // ncol).astype(np.uint32)
            cc = (seeds % ncol).astype(np.uint32)
            seeds = seeds[np.lexsort((cc, rr, zb))[:1]]
    else:
        seeds = np.atleast_1d(np.asarray(idxs_pit)).astype(np.int64)
    seeds = np.ascontiguousarray(seeds)
    _lib().priority_flood(
        work.ctypes.data_as(_F64P),
        d8.ctypes.data_as(_U8P),
        nrow,
        ncol,
        float("nan") if nan else float(nodata),
        float(max_depth),
        int(connectivity),
        seeds.ctypes.data_as(_I64P),
        seeds.size,
    )
    return work.astype(elevtn.dtype), d8


@_native
def dfs_preorder(idxs_ds):
    """DFS preorder of the flow forest (``csrc/host_kernels.cpp::dfs_preorder``).

    Returns int64 ``(preorder[:k], pos, size)``: subtree ``i`` is the
    preorder interval ``[pos[i], pos[i] + size[i])``; off-tree cells
    (missing, or on/into a cycle) have ``pos == -1`` and ``size == 0``.
    """
    ids = np.ascontiguousarray(idxs_ds, dtype=np.int64)
    n = ids.size
    preorder = np.empty(n, dtype=np.int64)
    pos = np.empty(n, dtype=np.int64)
    size = np.empty(n, dtype=np.int64)
    k = _lib().dfs_preorder(
        ids.ctypes.data_as(_I64P),
        n,
        preorder.ctypes.data_as(_I64P),
        pos.ctypes.data_as(_I64P),
        size.ctypes.data_as(_I64P),
    )
    return preorder[:k], pos, size


@_native
def flw_from_array_lut(flwdir, drlut, dclut, mv):
    """LUT-decode a uint8 flow-direction raster
    (``csrc/tile_plan_build.cpp::flw_from_array_lut``); returns
    ``(idxs_ds int32, idxs_pit int32, n_valid)``."""
    lib = _lib()
    flwdir = np.ascontiguousarray(flwdir, dtype=np.uint8)
    nrow, ncol = flwdir.shape
    idxs_ds = np.empty(nrow * ncol, np.int32)
    drlut = np.ascontiguousarray(drlut, dtype=np.int8)
    dclut = np.ascontiguousarray(dclut, dtype=np.int8)
    n_pit = ctypes.c_int64()
    n_valid = ctypes.c_int64()
    lib.flw_from_array_lut(
        flwdir.ctypes.data_as(_U8P), drlut.ctypes.data_as(_I8P),
        dclut.ctypes.data_as(_I8P), int(mv), nrow, ncol,
        idxs_ds.ctypes.data_as(_I32P), ctypes.byref(n_pit), ctypes.byref(n_valid),
    )
    pits = np.empty(n_pit.value, np.int32)
    lib.flw_collect_pits(
        idxs_ds.ctypes.data_as(_I32P), nrow * ncol, pits.ctypes.data_as(_I32P)
    )
    return idxs_ds, pits, int(n_valid.value)


@_native
def accuflux_sweep(idxs_ds, seq, accu):
    """Sequential accumulation ``accu[ds[i]] += accu[i]`` over ``seq`` reversed
    (``csrc/host_kernels.cpp::accuflux_sweep``). Returns a float64 copy."""
    ids = np.ascontiguousarray(idxs_ds, dtype=np.int64)
    seq = np.ascontiguousarray(seq, dtype=np.int64)
    accu = np.array(accu, dtype=np.float64)
    _lib().accuflux_sweep(
        ids.ctypes.data_as(_I64P), seq.ctypes.data_as(_I64P), seq.size,
        accu.ctypes.data_as(_F64P),
    )
    return accu


@_native
def tile_plan_phase1(ids_p, Hp, Wp, th):
    """Per-tile forest DFS and table fill of the tile plan build
    (``csrc/tile_plan_build.cpp::tp_phase1``, threaded over tiles) on the
    padded ``(Hp, Wp)`` grid with ``(th, 128)`` tiles. Returns a dict of the
    phase-1 intermediates (see ``ops/tile_plan.py``)."""
    lib = _lib()
    S = 128
    NT = (Hp // th) * (Wp // S)
    T = th * S
    n = Hp * Wp
    ids_p = np.ascontiguousarray(ids_p, dtype=np.int64)
    sig = np.empty((NT, T), np.int32)
    near_sel = np.zeros(NT * T, np.int8)
    idx_near = np.zeros(NT * T, np.int8)
    sel_next = np.zeros(NT * T, np.int8)
    tree_mask = np.empty(NT * T, np.int8)
    slot = np.empty(n, np.int32)
    root_node = np.empty(n, np.int32)
    cnt_on = np.empty(NT, np.int64)
    cnt_r = np.empty(NT, np.int64)
    cnt_far = np.empty(NT, np.int64)
    m = ctypes.c_int64()
    nf = ctypes.c_int64()
    h = lib.tp_phase1(
        ids_p.ctypes.data_as(_I64P), Hp, Wp, th,
        sig.ctypes.data_as(_I32P), near_sel.ctypes.data_as(_I8P),
        idx_near.ctypes.data_as(_I8P), sel_next.ctypes.data_as(_I8P),
        tree_mask.ctypes.data_as(_I8P), slot.ctypes.data_as(_I32P),
        root_node.ctypes.data_as(_I32P), cnt_on.ctypes.data_as(_I64P),
        cnt_r.ctypes.data_as(_I64P), cnt_far.ctypes.data_as(_I64P),
        ctypes.byref(m), ctypes.byref(nf),
    )
    root_cell = np.empty(m.value, np.int64)
    root_end = np.empty(m.value, np.int32)
    far_slot = np.empty(nf.value, np.int32)
    far_end = np.empty(nf.value, np.int32)
    lib.tp_phase1_export(  # copies the lists out and frees the handle
        h, root_cell.ctypes.data_as(_I64P), root_end.ctypes.data_as(_I32P),
        far_slot.ctypes.data_as(_I32P), far_end.ctypes.data_as(_I32P),
    )
    return {
        "sig": sig, "near_sel": near_sel, "idx_near": idx_near,
        "sel_next": sel_next, "tree_mask": tree_mask, "slot": slot,
        "root_node": root_node, "cnt_on": cnt_on, "cnt_r": cnt_r,
        "cnt_far": cnt_far, "root_cell": root_cell, "root_end": root_end,
        "far_slot": far_slot, "far_end": far_end,
    }


@_native
def tile_pad_bijection(tk, dk, sk, NT, T):
    """Per-tile bijections ``sigma`` (NT, T) int32 with ``sigma[tk, dk] = sk``;
    free destinations take free sources in index order
    (``csrc/tile_plan_build.cpp::tp_pad_bijection``). ``tk`` must be
    ascending."""
    tk = np.ascontiguousarray(tk, dtype=np.int64)
    dk = np.ascontiguousarray(dk, dtype=np.int64)
    sk = np.ascontiguousarray(sk, dtype=np.int64)
    if not (tk.size == dk.size == sk.size):
        raise ValueError("tk, dk and sk must have one length")
    sigma = np.empty((int(NT), int(T)), np.int32)
    _lib().tp_pad_bijection(
        tk.ctypes.data_as(_I64P), dk.ctypes.data_as(_I64P),
        sk.ctypes.data_as(_I64P), tk.size, int(NT), int(T),
        sigma.ctypes.data_as(_I32P),
    )
    return sigma


@_native
def tile_fwd_tables(sig, Y, G):
    """The JAX package's stacked 5-stage router tables of the per-tile
    permutations ``sig`` (NT, Y * 128) int32, ``Y = 128 G`` rows of ``G``
    groups of 128 x 128, with each tile's Hall colourings
    (``csrc/tile_plan_build.cpp::tp_fwd_tables``): ``(i1, is1, is2, i3,
    ig)``, int8, ``ig`` None where ``G`` is 1."""
    sig = np.ascontiguousarray(sig, dtype=np.int32)
    NT = sig.shape[0]
    if G < 1 or Y != 128 * G or sig.ndim != 2 or sig.shape[1] != Y * 128:
        raise ValueError(f"tile_fwd_tables: sig {sig.shape} is not (NT, Y * 128) with "
                         f"Y = 128 G (Y {Y}, G {G})")
    i1, is1, is2, i3 = (np.empty((NT, Y, 128), np.int8) for _ in range(4))
    ig = np.empty((NT, 128 * 128, G), np.int8) if G > 1 else None
    _lib().tp_fwd_tables(
        sig.ctypes.data_as(_I32P), NT, int(Y), int(G),
        i1.ctypes.data_as(_I8P), is1.ctypes.data_as(_I8P),
        is2.ctypes.data_as(_I8P), i3.ctypes.data_as(_I8P),
        ig.ctypes.data_as(_I8P) if ig is not None else None,
    )
    return i1, is1, is2, i3, ig


@_native
def tile_inv_rows(t):
    """Row-wise inverse of stacked int8 permutation tables (..., S)
    (``csrc/tile_plan_build.cpp::tp_inv_rows``)."""
    t = np.ascontiguousarray(t, dtype=np.int8)
    out = np.empty_like(t)
    s = t.shape[-1]
    _lib().tp_inv_rows(t.ctypes.data_as(_I8P), t.size // s, s, out.ctypes.data_as(_I8P))
    return out


@_native
def bipartite_color(u, v, nL, nR, deg):
    """Colours (int32, in ``[0, deg)``) of the edges ``(u[e], v[e])`` of a
    ``deg``-regular bipartite multigraph, ``deg`` a power of two, by Euler
    splits (``csrc/host_kernels.cpp::bipartite_color``)."""
    u = np.ascontiguousarray(u, dtype=np.int64)
    v = np.ascontiguousarray(v, dtype=np.int64)
    deg = int(deg)
    if (u.size != v.size or deg < 1 or deg & (deg - 1)
            or (u.size and (u.min() < 0 or u.max() >= nL or v.min() < 0 or v.max() >= nR))):
        raise ValueError("bipartite_color: u, v of one length with ids below nL, nR, and "
                         "deg a power of two")
    out = np.empty(u.size, dtype=np.int32)
    _lib().bipartite_color(u.ctypes.data_as(_I64P), v.ctypes.data_as(_I64P), u.size,
                           int(nL), int(nR), int(deg), out.ctypes.data_as(_I32P))
    return out


@_native
def tile_down_phase(near_sel, idx_near, sel_next, sig, cnt_far, far_slot, far_end, NT, T):
    """Per-tile sort phase of the tile plan's downward sweep
    (``csrc/tile_plan_build.cpp::tp_down_phase``, threaded over tiles): the
    stable (interval end, slot) order of each tile's preorder slots and the
    boundaries of its runs of equal ends. Inputs are phase-1 outputs
    (:func:`tile_plan_phase1`). Returns ``(sig_es, sig_dea, sig_deb, de_sel,
    de_b0)``, each (NT, T): the raster cell at each sorted position; for
    each end slot (``de_sel``) the sorted position of its run's last member
    and of the member before its run (none where ``de_b0``), both padded to
    bijections."""
    NT, T = int(NT), int(T)
    near_sel = np.ascontiguousarray(near_sel, dtype=np.int8)
    idx_near = np.ascontiguousarray(idx_near, dtype=np.int8)
    sel_next = np.ascontiguousarray(sel_next, dtype=np.int8)
    sig = np.ascontiguousarray(sig, dtype=np.int32)
    cnt_far = np.ascontiguousarray(cnt_far, dtype=np.int64)
    far_slot = np.ascontiguousarray(far_slot, dtype=np.int32)
    far_end = np.ascontiguousarray(far_end, dtype=np.int32)
    if not (near_sel.size == idx_near.size == sel_next.size == sig.size == NT * T):
        raise ValueError("phase-1 tables must hold NT * T entries")
    if cnt_far.size != NT or far_slot.size != far_end.size or far_slot.size != cnt_far.sum():
        raise ValueError("far lists do not match cnt_far")
    sig_es = np.empty((NT, T), np.int32)
    sig_dea = np.empty((NT, T), np.int32)
    sig_deb = np.empty((NT, T), np.int32)
    de_sel = np.empty((NT, T), np.int8)
    de_b0 = np.empty((NT, T), np.int8)
    _lib().tp_down_phase(
        near_sel.ctypes.data_as(_I8P), idx_near.ctypes.data_as(_I8P),
        sel_next.ctypes.data_as(_I8P), sig.ctypes.data_as(_I32P),
        cnt_far.ctypes.data_as(_I64P), far_slot.ctypes.data_as(_I32P),
        far_end.ctypes.data_as(_I32P), NT, T,
        sig_es.ctypes.data_as(_I32P), sig_dea.ctypes.data_as(_I32P),
        sig_deb.ctypes.data_as(_I32P), de_sel.ctypes.data_as(_I8P),
        de_b0.ctypes.data_as(_I8P),
    )
    return sig_es, sig_dea, sig_deb, de_sel, de_b0


@_native
def downward_sweep(idxs_ds, seq, w):
    """Sequential downstream-path sum ``out[i] = w[i] + out[ds(i)]`` (pits:
    ``w[i]``) over ``seq``, which lists downstream cells before upstream ones
    (``csrc/tile_plan_build.cpp::downward_sweep``). Cells not in ``seq`` keep
    ``w``. Returns float64."""
    ids = np.ascontiguousarray(idxs_ds, dtype=np.int64)
    seq = np.ascontiguousarray(seq, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    out = w.copy()
    _lib().downward_sweep(
        ids.ctypes.data_as(_I64P), seq.ctypes.data_as(_I64P), seq.size,
        w.ctypes.data_as(_F64P), out.ctypes.data_as(_F64P),
    )
    return out


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _mask_arg(mask):
    """``mask`` as a contiguous uint8 array and its pointer; (None, None)
    for no mask. Keep the array alive while the pointer is in use."""
    if mask is None:
        return None, None
    m = np.ascontiguousarray(mask, dtype=np.uint8).ravel()
    return m, m.ctypes.data_as(ctypes.c_void_p)


@_native
def strahler_order(idxs_ds, preorder, mask=None):
    """Strahler order (uint8) by one sweep over the DFS ``preorder``
    reversed (``csrc/host_kernels.cpp::strahler_order_host``); cells outside
    ``mask`` are 0 and invisible to their downstream cells."""
    ids = _i64(idxs_ds)
    pre = _i64(preorder)
    out = np.zeros(ids.size, dtype=np.uint8)
    _keep, mask_p = _mask_arg(mask)
    _lib().strahler_order_host(
        ids.ctypes.data_as(_I64P), pre.ctypes.data_as(_I64P), pre.size, ids.size,
        mask_p, out.ctypes.data_as(_U8P),
    )
    return out


@_native
def classic_order(idxs_ds, preorder, idxs_us_main, nup, mask=None):
    """Classic (Hack) order (uint8) by one sweep over the DFS ``preorder``
    (``csrc/host_kernels.cpp::classic_order_host``): main stems 1, each
    tributary one above the stream it joins. ``nup`` is the int8 upstream
    count."""
    ids = _i64(idxs_ds)
    pre = _i64(preorder)
    usm = _i64(idxs_us_main)
    nup8 = np.ascontiguousarray(nup, dtype=np.int8)
    out = np.zeros(ids.size, dtype=np.uint8)
    _keep, mask_p = _mask_arg(mask)
    _lib().classic_order_host(
        ids.ctypes.data_as(_I64P), pre.ctypes.data_as(_I64P),
        usm.ctypes.data_as(_I64P), pre.size, ids.size, mask_p,
        nup8.ctypes.data_as(_I8P), out.ctypes.data_as(_U8P),
    )
    return out


@_native
def stream_segments(nxt, order, nup, mask=None, max_len=0):
    """Confluence-to-confluence stream reaches in CSR form, reaches longer
    than ``max_len`` cut into pieces and a stub appended at each pit
    (``csrc/network_kernels.cpp::stream_segments_count/fill``). ``order``
    lists the segment heads up- to downstream. Returns ``(seg_off, data)``,
    int64."""
    lib = _lib()
    nxt = _i64(nxt)
    order = _i64(order)
    nup32 = np.ascontiguousarray(nup, dtype=np.int32)
    _keep, mask_p = _mask_arg(mask)
    nseg = np.zeros(1, dtype=np.int64)
    ndata = np.zeros(1, dtype=np.int64)
    args = (nxt.ctypes.data_as(_I64P), order.ctypes.data_as(_I64P), order.size, nxt.size,
            mask_p, nup32.ctypes.data_as(_I32P), int(max_len))
    lib.stream_segments_count(*args, nseg.ctypes.data_as(_I64P), ndata.ctypes.data_as(_I64P))
    seg_off = np.empty(int(nseg[0]) + 1, dtype=np.int64)
    data = np.empty(int(ndata[0]), dtype=np.int64)
    lib.stream_segments_fill(*args, seg_off.ctypes.data_as(_I64P), data.ctypes.data_as(_I64P))
    return seg_off, data


@_native
def smooth_rivlen(nxt, us_main, rivlen, min_rivlen, max_window, nodata):
    """River lengths below ``min_rivlen`` smoothed over a growing window, in
    cell order (``csrc/network_kernels.cpp::smooth_rivlen_host``). Returns a
    new float64 array."""
    nxt = _i64(nxt)
    us = _i64(us_main)
    out = np.array(rivlen, dtype=np.float64).ravel()
    if not (us.size == out.size == nxt.size):
        raise ValueError("us_main and rivlen must hold one value per cell")
    _lib().smooth_rivlen_host(
        nxt.ctypes.data_as(_I64P), us.ctypes.data_as(_I64P), nxt.size,
        out.ctypes.data_as(_F64P), float(min_rivlen), int(max_window), float(nodata),
    )
    return out


@_native
def subbasin_area_outlets(nxt, us_main, order, uparea, area_min):
    """Outlets of sub-basins of at least ``area_min`` by one down- to
    upstream sweep over ``order``
    (``csrc/network_kernels.cpp::subbasin_area_outlets``). Returns
    ``(labels, outlets)``: uint32 labels at the outlets (0 elsewhere) and
    the int64 outlet cells."""
    nxt = _i64(nxt)
    us = _i64(us_main)
    order = _i64(order)
    upa = np.ascontiguousarray(uparea, dtype=np.float64).ravel()
    if not (us.size == upa.size == nxt.size):
        raise ValueError("us_main and uparea must hold one value per cell")
    labels = np.zeros(nxt.size, dtype=np.uint32)
    outlets = np.empty(nxt.size, dtype=np.int64)
    k = _lib().subbasin_area_outlets(
        nxt.ctypes.data_as(_I64P), us.ctypes.data_as(_I64P), order.ctypes.data_as(_I64P),
        order.size, nxt.size, upa.ctypes.data_as(_F64P), float(area_min),
        labels.ctypes.data_as(_U32P), outlets.ctypes.data_as(_I64P),
    )
    return labels, outlets[:k]


@_native
def trace_walks(nxt, seeds, mask=None, stepx=None, stepy=None, ncol=0, max_length=-1.0):
    """Walks along ``nxt`` from each seed, in CSR form
    (``csrc/network_kernels.cpp::trace_walks_count/fill``): a walk stops at a
    pit or a missing next cell, at a True ``mask`` cell (the seed included),
    or before the step that would take its distance past ``max_length``
    (negative: no limit). ``stepx`` / ``stepy`` are (2 nrow,) step lengths
    indexed by the sum of the two rows, or None for unit steps. Returns
    ``(offsets, data, dists)``: int64, int64 and float64."""
    lib = _lib()
    nxt = _i64(nxt)
    seeds = _i64(seeds).ravel()
    m = seeds.size
    _keep, mask_p = _mask_arg(mask)
    if stepx is not None:
        stepx = np.ascontiguousarray(stepx, dtype=np.float64)
        stepy = np.ascontiguousarray(stepy, dtype=np.float64)
        sx_p = stepx.ctypes.data_as(ctypes.c_void_p)
        sy_p = stepy.ctypes.data_as(ctypes.c_void_p)
    else:
        sx_p = sy_p = None
    counts = np.empty(m, dtype=np.int64)
    dists = np.empty(m, dtype=np.float64)
    args = (nxt.ctypes.data_as(_I64P), nxt.size, seeds.ctypes.data_as(_I64P), m, mask_p,
            sx_p, sy_p, int(ncol), float(max_length))
    lib.trace_walks_count(*args, counts.ctypes.data_as(_I64P),
                          dists.ctypes.data_as(ctypes.c_void_p))
    offsets = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    data = np.empty(int(offsets[-1]), dtype=np.int64)
    lib.trace_walks_fill(*args, offsets.ctypes.data_as(_I64P),
                         data.ctypes.data_as(ctypes.c_void_p))
    return offsets, data, dists


@_native
def spread2d(obs, msk=None, nodata=0, frc=None, latlon=False, transform=None):
    """Each cell's nearest observation (``obs`` other than ``nodata``) by a
    Dijkstra spread through the ``msk`` cells, the step lengths times the
    friction ``frc`` where given, diagonal steps the hypotenuse, degrees made
    metres a row where ``latlon`` (``csrc/host_kernels.cpp::spread2d``).
    Returns ``(out, src, dst)``: the spread values in ``obs``' dtype, the
    int32 linear index of each cell's source and the float32 distance to
    it."""
    from ..utils import geodesy
    from ..utils.affine import IDENTITY

    if transform is None:
        transform = IDENTITY
    obs = np.asarray(obs)
    nrow, ncol = obs.shape
    obs64 = np.ascontiguousarray(obs, dtype=np.float64)
    xres, yres, north = transform[0], abs(transform[4]), transform[5]
    dxs = dys = None
    if latlon:
        lats = north + (np.arange(nrow) + 0.5) * yres
        dys = np.ascontiguousarray(geodesy.degree_metres_y(lats) * yres)
        dxs = np.ascontiguousarray(geodesy.degree_metres_x(lats) * xres)
    msk_arr = None if msk is None else np.ascontiguousarray(msk, dtype=np.uint8)
    frc_arr = None if frc is None else np.ascontiguousarray(frc, dtype=np.float64)

    def ptr(a):
        return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    out = np.zeros((nrow, ncol), dtype=np.float64)
    src = np.zeros((nrow, ncol), dtype=np.int32)
    dst = np.zeros((nrow, ncol), dtype=np.float32)
    _lib().spread2d(
        obs64.ctypes.data_as(_F64P), ptr(msk_arr), ptr(frc_arr), nrow, ncol,
        float(nodata), int(bool(latlon)), ptr(dxs), ptr(dys), float(xres), float(yres),
        out.ctypes.data_as(_F64P), src.ctypes.data_as(_I32P),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out.astype(obs.dtype), src, dst


@_native
def channel_paths(nxt, seeds, mask=None, max_len=0, include_outlet=False):
    """Walks along ``nxt`` from each outlet pixel in ``seeds`` to the next
    outlet pixel, in CSR form (``csrc/network_kernels.cpp::ucat_paths_count
    / ucat_paths_fill``; upstream pyflwdir ``subgrid.py:146-410`` walk
    semantics). Returns ``(offsets, data, ends, kinds)``: the (m + 1,)
    offsets and the concatenated pixels (int64), each walk's last pixel and
    its kind (int8: 0 other, 1 outlet, 2 pit)."""
    lib = _lib()
    nxt = _i64(nxt)
    seeds = _i64(seeds).ravel()
    m = seeds.size
    counts = np.empty(m, dtype=np.int64)
    ends = np.empty(m, dtype=np.int64)
    kinds = np.empty(m, dtype=np.int8)
    _keep, mask_p = _mask_arg(mask)
    if _keep is not None and _keep.size != nxt.size:
        raise ValueError("mask must hold one value per cell")
    lib.ucat_paths_count(
        nxt.ctypes.data_as(_I64P), nxt.size, seeds.ctypes.data_as(_I64P), m, mask_p,
        int(max_len), int(bool(include_outlet)), counts.ctypes.data_as(_I64P),
        ends.ctypes.data_as(_I64P), kinds.ctypes.data_as(_I8P),
    )
    offsets = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    data = np.empty(int(offsets[-1]), dtype=np.int64)
    # the fill walks the pointer chain for each seed's counted length only
    seeds_safe = np.where(seeds < 0, 0, seeds)
    lib.ucat_paths_fill(
        nxt.ctypes.data_as(_I64P), nxt.size, seeds_safe.ctypes.data_as(_I64P), m,
        offsets.ctypes.data_as(_I64P), data.ctypes.data_as(_I64P),
    )
    return offsets, data, ends, kinds


@_native
def fixed_windows(nxt, us_main, distnc, seeds, length, mask=None):
    """Main-stem windows of about ``length`` (in ``distnc`` units) centred
    on each of ``seeds``, in CSR form
    (``csrc/network_kernels.cpp::fixed_window_count / fixed_window_fill``;
    upstream pyflwdir ``subgrid.py:488-559`` walk semantics). Returns
    ``(offsets, data)``, int64."""
    lib = _lib()
    nxt = _i64(nxt)
    us = _i64(us_main)
    seeds = _i64(seeds).ravel()
    dst = np.ascontiguousarray(distnc, dtype=np.float64).ravel()
    if not (us.size == dst.size == nxt.size):
        raise ValueError("us_main and distnc must hold one value per cell")
    m = seeds.size
    starts = np.empty(m, dtype=np.int64)
    counts = np.empty(m, dtype=np.int64)
    _keep, mask_p = _mask_arg(mask)
    lib.fixed_window_count(
        nxt.ctypes.data_as(_I64P), us.ctypes.data_as(_I64P), dst.ctypes.data_as(_F64P),
        mask_p, seeds.ctypes.data_as(_I64P), m, float(length),
        starts.ctypes.data_as(_I64P), counts.ctypes.data_as(_I64P),
    )
    offsets = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    data = np.empty(int(offsets[-1]), dtype=np.int64)
    lib.fixed_window_fill(
        us.ctypes.data_as(_I64P), starts.ctypes.data_as(_I64P), m,
        offsets.ctypes.data_as(_I64P), data.ctypes.data_as(_I64P),
    )
    return offsets, data


@_native
def adjust_elevation(nxt, order, elevtn):
    """Streamline profile conditioning in the headwater-first ``order``
    (``csrc/network_kernels.cpp::adjust_elevation_host``; upstream pyflwdir
    ``dem.py:147-225`` semantics). Returns a new float64 array."""
    nxt = _i64(nxt)
    order = _i64(order)
    z = np.array(elevtn, dtype=np.float64).ravel()
    if z.size != nxt.size:
        raise ValueError("elevtn must hold one value per cell")
    _lib().adjust_elevation_host(
        nxt.ctypes.data_as(_I64P), order.ctypes.data_as(_I64P), order.size, nxt.size,
        z.ctypes.data_as(_F64P),
    )
    return z


@_native
def repair_profile(profile):
    """Minimum-modification repair of one up- to downstream profile
    (``csrc/network_kernels.cpp::repair_profile_host``). Returns a new
    float64 array."""
    z = np.array(profile, dtype=np.float64).ravel()
    _lib().repair_profile_host(z.ctypes.data_as(_F64P), z.size)
    return z


@_native
def dig_d4(nxt, order, shape, elevtn, mask=None, nodata=-9999.0, dz_min=1e-3):
    """Dig a D4-connected channel along each diagonal D8 link, in the
    headwater-first ``order`` (``csrc/network_kernels.cpp::dig_d4_host``;
    upstream pyflwdir ``dem.py:405-439`` semantics). Returns a new float64
    array."""
    nxt = _i64(nxt)
    order = _i64(order)
    z = np.array(elevtn, dtype=np.float64).ravel()
    if not (z.size == nxt.size == int(shape[0]) * int(shape[1])):
        raise ValueError("elevtn must hold one value per cell of shape")
    _keep, mask_p = _mask_arg(mask)
    _lib().dig_d4_host(
        nxt.ctypes.data_as(_I64P), order.ctypes.data_as(_I64P), order.size, nxt.size,
        int(shape[0]), int(shape[1]), mask_p, z.ctypes.data_as(_F64P), float(nodata),
        float(dz_min),
    )
    return z


def _ihu_args(cell_ds, cell_out, pix_ds, pix_upa, shape, subncol, cellsize):
    """The pointers and dimensions the IHU repairs share. ``cell_ds`` and
    ``cell_out`` are mutated in place, so they must already be contiguous
    int64; ``pix_ds`` int64 and ``pix_upa`` float64 are read only."""
    for name, a, dt in (("cell_ds", cell_ds, np.int64), ("cell_out", cell_out, np.int64),
                        ("pix_ds", pix_ds, np.int64), ("pix_upa", pix_upa, np.float64)):
        if a.dtype != dt or not a.flags.c_contiguous:
            raise TypeError(f"{name} must be a contiguous {np.dtype(dt).name} array")
    if cell_out.size != cell_ds.size or pix_upa.size != pix_ds.size:
        raise ValueError("cell_out / pix_upa must match cell_ds / pix_ds")
    return (
        cell_ds.ctypes.data_as(_I64P), cell_out.ctypes.data_as(_I64P),
        pix_ds.ctypes.data_as(_I64P), pix_upa.ctypes.data_as(_F64P),
        cell_ds.size, pix_ds.size, int(shape[0]), int(shape[1]), int(subncol), int(cellsize),
    )


@_native
def ihu_relocate(cell_ds, cell_out, pix_ds, pix_upa, broken, shape, subncol, cellsize):
    """IHU outlet relocation (``csrc/upscale_kernels.cpp::ihu_relocate``;
    upstream pyflwdir ``upscale.py:499-877``): mutates ``cell_ds`` /
    ``cell_out`` in place; ``broken`` comes sorted by ascending outlet
    uparea. Returns the cells still broken (int64)."""
    broken = _i64(broken)
    args = _ihu_args(cell_ds, cell_out, pix_ds, pix_upa, shape, subncol, cellsize)
    still = np.empty(max(broken.size, 1), dtype=np.int64)
    k = _lib().ihu_relocate(*args, broken.ctypes.data_as(_I64P), broken.size,
                            still.ctypes.data_as(_I64P))
    return still[:k]


def _strm_valid(strm, valid, nsub, nlow):
    if strm.dtype != np.int32 or not strm.flags.c_contiguous or strm.size != nsub:
        raise TypeError("strm must be a contiguous int32 array, one value a pixel")
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    if valid.size != nlow:
        raise ValueError("valid must hold one value per lowres cell")
    return strm.ctypes.data_as(_I32P), valid


@_native
def ihu_opt_rivlen(cell_ds, cell_out, strm, valid, pix_ds, pix_upa, shorts, shape, subncol,
                   cellsize, minlen, minupa):
    """IHU short-reach optimisation (``csrc/upscale_kernels.cpp::
    ihu_opt_rivlen``; upstream pyflwdir ``upscale.py:971-1019``): mutates
    ``cell_ds`` / ``cell_out`` / ``strm`` in place."""
    shorts = _i64(shorts)
    args = _ihu_args(cell_ds, cell_out, pix_ds, pix_upa, shape, subncol, cellsize)
    strm_p, valid = _strm_valid(strm, valid, pix_ds.size, cell_ds.size)
    _lib().ihu_opt_rivlen(*args[:2], strm_p, valid.ctypes.data_as(_U8P), *args[2:],
                          shorts.ctypes.data_as(_I64P), shorts.size, float(minlen),
                          float(minupa))


@_native
def ihu_min_error(cell_ds, cell_out, strm, valid, pix_ds, pix_upa, broken, shape, subncol,
                  cellsize, minlen, minupa, pit_out_of_cell):
    """IHU upstream-area error minimisation (``csrc/upscale_kernels.cpp::
    ihu_min_error``; upstream pyflwdir ``upscale.py:1022-1152``): mutates
    ``cell_ds`` / ``cell_out`` / ``strm`` in place; ``broken`` comes sorted
    by descending outlet uparea."""
    broken = _i64(broken)
    args = _ihu_args(cell_ds, cell_out, pix_ds, pix_upa, shape, subncol, cellsize)
    strm_p, valid = _strm_valid(strm, valid, pix_ds.size, cell_ds.size)
    _lib().ihu_min_error(*args[:2], strm_p, valid.ctypes.data_as(_U8P), *args[2:],
                         broken.ctypes.data_as(_I64P), broken.size, float(minlen),
                         float(minupa), int(pit_out_of_cell))
