"""ctypes binding of the shared native host library ``csrc/libpyflwdir_host.so``.

Binds only what the port uses so far: the priority-flood depression fill,
the DFS preorder, the LUT flow-direction parser, the sequential
accumulation sweeps upward and downward (the oracles the device paths are
held against) and the tile plan's per-tile DFS, bijection padding and
downward sort phase. The library is
git-ignored; at first use it is built with ``make -C csrc``, and a failed
build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = [
    "priority_flood",
    "dfs_preorder",
    "flw_from_array_lut",
    "accuflux_sweep",
    "tile_plan_phase1",
    "tile_pad_bijection",
    "tile_down_phase",
    "downward_sweep",
]

_CSRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "csrc"))
_LIB_PATH = os.path.join(_CSRC, "libpyflwdir_host.so")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F64P = ctypes.POINTER(ctypes.c_double)

_LIB = []  # the loaded library, once


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
    lib.downward_sweep.restype = None
    lib.downward_sweep.argtypes = [_I64P, _I64P, ctypes.c_int64, _F64P, _F64P]
    _LIB.append(lib)
    return lib


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
