"""Flow-direction upscaling: DMM, EAM, EAM+ and IHU (upstream pyflwdir
``upscale.py``).

* The maps over every highres pixel run on the device: the cell-edge and
  effective-area masks (a table of one lowres cell's offsets, gathered by
  each pixel's offset in its cell), the representative-cell choice (a
  scatter-max of the upstream area, then a scatter-min of the index among
  the pixels that reach it), and IHU's outlet trace, one pointer-doubling
  ``reach`` with a static stop mask: a pixel stops where its downstream
  pixel lies in another lowres cell. All are integer or max/min
  reductions, so exact.
* The walks between lowres cells (DMM / EAM / IHU next cells, the error
  and check walks) run on the host in numpy, in lockstep, each step the
  JAX package's; only the walks still active are stepped.
* The IHU repairs (relocate, short reaches, upstream-area error) are
  sequential mutations with rollback over a few problem cells: the native
  host library, as in the JAX package. Their cells are ordered with the
  JAX package's ``np.argsort`` call on the upstream area as the caller gave
  it: numpy's default sort is not stable, and ties are common.

Naming follows upstream: ``idx`` / ``ncol`` lowres, ``subidx`` /
``subncol`` highres. Index outputs are int64 numpy arrays; -1 is missing.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ._backend import resolve_device

__all__ = [
    "dmm",
    "eam",
    "eam_plus",
    "ihu",
    "ihu_tiled",
    "upscale_error",
    "upscale_check",
]

_MV = -1
_I64_MAX = np.iinfo(np.int64).max


# ---------------------------------------------------------------------------
# helpers (numpy, as the JAX package's)
# ---------------------------------------------------------------------------


def _host(a):
    """``a`` as a numpy array (a tensor copied to the host)."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _host_i64(a):
    return np.ascontiguousarray(_host(a), dtype=np.int64)


def _dev(a, dev):
    """``a`` as a tensor on ``dev``."""
    return a.to(dev) if torch.is_tensor(a) else torch.as_tensor(np.asarray(a), device=dev)


def _lowres_shape(subshape, cellsize):
    subnrow, subncol = subshape
    return (int(np.ceil(subnrow / cellsize)), int(np.ceil(subncol / cellsize)))


def subidx_2_idx(subidx, subncol, cellsize, ncol):
    """Lowres index of each highres index (upstream ``upscale.py:23-27``)."""
    subidx = np.asarray(subidx)
    r = (subidx // subncol) // cellsize
    c = (subidx % subncol) // cellsize
    return r * ncol + c


def in_d8(idx0, idx_ds, ncol):
    """True where ``idx_ds`` lies in the 3x3 neighbourhood of ``idx0``
    (upstream ``upscale.py:31-35``)."""
    idx0 = np.asarray(idx0)
    idx_ds = np.asarray(idx_ds)
    cond1 = np.abs((idx_ds % ncol).astype(np.int64) - (idx0 % ncol).astype(np.int64)) <= 1
    cond2 = np.abs((idx_ds // ncol).astype(np.int64) - (idx0 // ncol).astype(np.int64)) <= 1
    return np.logical_and(cond1, cond2)


def _edge_rc(ri, ci, cellsize):
    return (ri == 0) | (ci == 0) | (ri + 1 == cellsize) | (ci + 1 == cellsize)


def _effare_rc(ri, ci, cellsize, r_ratio):
    R = cellsize * r_ratio
    offset = cellsize / 2.0 - 0.5
    ri = np.abs(ri - offset)
    ci = np.abs(ci - offset)
    return (ri**0.5 + ci**0.5 <= R**0.5) | (ri <= 0.5) | (ci <= 0.5)


def cell_edge(subidx, subncol, cellsize):
    """True where a highres pixel lies on the edge of its lowres cell
    (upstream ``upscale.py:42-46``)."""
    subidx = np.asarray(subidx)
    return _edge_rc((subidx // subncol) % cellsize, (subidx % subncol) % cellsize, cellsize)


def effective_area(subidx, subncol, cellsize, r_ratio=0.5):
    """True where a highres pixel lies in its lowres cell's EAM effective
    (diamond) area (upstream ``upscale.py:215-223``)."""
    subidx = np.asarray(subidx)
    return _effare_rc((subidx // subncol) % cellsize, (subidx % subncol) % cellsize, cellsize,
                      r_ratio)


# ---------------------------------------------------------------------------
# the maps over every pixel, on the device
# ---------------------------------------------------------------------------


def _cell_table(fn, cellsize, dev, *args):
    """``fn`` over the offsets of one lowres cell, a (cellsize, cellsize)
    bool tensor: the numpy formula, evaluated once for each offset."""
    ar = np.arange(cellsize)
    return torch.as_tensor(np.asarray(fn(ar[:, None], ar[None, :], cellsize, *args)),
                           device=dev)


class _Pixels:
    """Each pixel's global index, its row and column offsets in its lowres
    cell and its lowres index, for the pixels ``off`` .. ``off + n`` of a
    grid ``subncol`` wide."""

    def __init__(self, n, off, subncol, cellsize, ncol, dev):
        self.sub = torch.arange(off, off + n, dtype=torch.int64, device=dev)
        r, c = self.sub // subncol, self.sub % subncol
        self.ri, self.ci = r % cellsize, c % cellsize
        self.low = (r // cellsize) * ncol + c // cellsize
        self.subncol, self.cellsize, self.ncol = subncol, cellsize, ncol

    def lowres(self, sub):
        return ((sub // self.subncol) // self.cellsize) * self.ncol + (
            sub % self.subncol) // self.cellsize

    def table(self, tab):
        return tab[self.ri, self.ci]


def _scatter_argmax(sel, tgt, sub, upa, nlow):
    """For each of ``nlow`` cells, the ``sub`` of the selected pixel with
    the largest ``upa`` (float64), the lowest ``sub`` among equal ones (the
    upstream ascending scan's strict-greater update); -1 where the largest
    is not above 0. A scatter-max, then a scatter-min over the pixels that
    reach it: both exact."""
    drop = torch.full_like(tgt, nlow)
    tgt = torch.where(sel, tgt, drop)
    best = torch.zeros(nlow + 1, dtype=torch.float64, device=tgt.device)
    best.scatter_reduce_(0, tgt, upa, reduce="amax", include_self=True)
    cand = sel & (upa == best[tgt]) & (upa > 0)
    idx = torch.full((nlow + 1,), _I64_MAX, dtype=torch.int64, device=tgt.device)
    idx.scatter_reduce_(0, torch.where(cand, tgt, drop),
                        torch.where(cand, sub, torch.full_like(sub, _I64_MAX)),
                        reduce="amin", include_self=True)
    idx = idx[:nlow]
    return torch.where(idx == _I64_MAX, torch.full_like(idx, _MV), idx)


def _repcell(ds, upa, px, tab, nlow, lo0=0, mv=_MV):
    """The largest-uparea pixel of each lowres cell among its valid pixels
    where ``tab`` holds, and its pits; ``lo0`` the first lowres cell."""
    valid = ds != mv
    sel = valid & ((ds == px.sub) | px.table(tab))
    return _scatter_argmax(sel, px.low - lo0, px.sub, upa, nlow)


def _grid_args(subidxs_ds, subuparea, subshape, shape, cellsize, device):
    dev = resolve_device(device)
    ds = _dev(subidxs_ds, dev).to(torch.int64)
    upa = _dev(subuparea, dev).to(torch.float64)
    return dev, ds, upa, _Pixels(ds.shape[0], 0, subshape[1], cellsize, shape[1], dev)


def map_celledge(subidxs_ds, subshape, cellsize, mv=_MV):
    """int8 map: 1 on lowres cell edges, 0 inside, -1 missing (upstream
    ``upscale.py:50-63``)."""
    subidxs_ds = _host(subidxs_ds)
    edge = cell_edge(np.arange(subidxs_ds.size), subshape[1], cellsize)
    out = np.where(edge, np.int8(1), np.int8(0))
    return np.where(subidxs_ds == mv, np.int8(-1), out)


def map_effare(subidxs_ds, subshape, cellsize, r_ratio=0.5, mv=_MV):
    """int8 map: 1 in the effective areas, 0 outside, -1 missing (upstream
    ``upscale.py:227-240``)."""
    subidxs_ds = _host(subidxs_ds)
    ea = effective_area(np.arange(subidxs_ds.size), subshape[1], cellsize, r_ratio)
    out = np.where(ea, np.int8(1), np.int8(0))
    return np.where(subidxs_ds == mv, np.int8(-1), out)


def dmm_exitcell(subidxs_ds, subuparea, subshape, shape, cellsize, mv=_MV, device=None):
    """DMM exit cells: the largest-uparea pixel on each lowres cell's edge
    or among its pits (upstream ``upscale.py:67-111``), on ``device``."""
    dev, ds, upa, px = _grid_args(subidxs_ds, subuparea, subshape, shape, cellsize, device)
    tab = _cell_table(_edge_rc, cellsize, dev)
    return _repcell(ds, upa, px, tab, shape[0] * shape[1], mv=mv).cpu().numpy()


def eam_repcell(subidxs_ds, subuparea, subshape, shape, cellsize, r_ratio=0.5, mv=_MV,
                device=None):
    """EAM representative cells: the largest-uparea pixel in each lowres
    cell's effective area or among its pits (upstream
    ``upscale.py:244-287``), on ``device``."""
    dev, ds, upa, px = _grid_args(subidxs_ds, subuparea, subshape, shape, cellsize, device)
    tab = _cell_table(_effare_rc, cellsize, dev, r_ratio)
    return _repcell(ds, upa, px, tab, shape[0] * shape[1], mv=mv).cpu().numpy()


def _outlet_trace(ds, px, mv=_MV):
    """Each pixel traced downstream to the last pixel of its lowres cell:
    one ``reach`` with a static stop mask, a pixel whose downstream pixel
    leaves the cell or a pit."""
    from .ops import graph

    valid = ds != mv
    dsv = torch.where(valid, ds, px.sub)
    stop = (px.low != px.lowres(dsv)) | (valid & (ds == px.sub))
    # a pixel that is its own (band-local) index is a pit for reach
    return graph.reach(torch.where(valid, ds - px.sub[0], torch.full_like(ds, -1)),
                       stop & valid) + px.sub[0]


def ihu_outlets(subidxs_rep, subidxs_ds, subuparea, subshape, shape, cellsize, mv=_MV,
                device=None):
    """IHU outlet pixels: each representative pixel traced downstream to
    the last pixel of its lowres cell (upstream ``upscale.py:381-434``), by
    one pointer-doubling ``reach`` over the highres grid on ``device``."""
    dev = resolve_device(device)
    ds = _dev(subidxs_ds, dev).to(torch.int64)
    px = _Pixels(ds.shape[0], 0, subshape[1], cellsize, shape[1], dev)
    t = _outlet_trace(ds, px, mv)
    rep = _dev(subidxs_rep, dev).to(torch.int64)
    return torch.where(rep != mv, t[rep.clamp(min=0)], rep).cpu().numpy()


# ---------------------------------------------------------------------------
# the lockstep walks, on the host
# ---------------------------------------------------------------------------


def dmm_nextidx(subidxs_rep, subidxs_ds, subshape, shape, cellsize, mv=_MV):
    """DMM next lowres cell: each representative pixel traced downstream
    until it leaves a half-cell-buffered box around its (offset) lowres
    cell (upstream ``upscale.py:115-169``)."""
    subidxs_rep, subidxs_ds = _host(subidxs_rep), _host(subidxs_ds)
    _, subncol = subshape
    nrow, ncol = shape
    R = cellsize / 2
    idxs_ds = np.full(nrow * ncol, mv, dtype=np.int64)
    idx0 = np.where(subidxs_rep != mv)[0]
    if idx0.size == 0:
        return idxs_ds
    sub = subidxs_rep[idx0].astype(np.int64)
    # highres coordinates of the offset lowres cell's centre
    dr = (sub // subncol) % cellsize // R
    dc = (sub % subncol) % cellsize // R
    subr0 = (idx0 // ncol + dr) * cellsize - 0.5
    subc0 = (idx0 % ncol + dc) * cellsize - 0.5
    cur = sub.copy()
    out = idx0.astype(np.int64)  # the walk's current lowres cell
    ai = np.arange(idx0.size)
    for _ in range(subidxs_ds.size):
        if not ai.size:
            break
        c = cur[ai]
        sub1 = subidxs_ds[c].astype(np.int64)
        low1 = subidx_2_idx(sub1, subncol, cellsize, ncol)
        beyond = (np.abs(c // subncol - subr0[ai]) > R) | (np.abs(c % subncol - subc0[ai]) > R)
        step = ~((sub1 == c) | ((low1 != idx0[ai]) & beyond))
        cur[ai[step]] = sub1[step]
        out[ai[step]] = low1[step]
        ai = ai[step]
    idxs_ds[idx0] = out
    return idxs_ds


def eam_nextidx(subidxs_rep, subidxs_ds, subshape, shape, cellsize, r_ratio=0.5, mv=_MV):
    """EAM next lowres cell: each representative pixel traced to the next
    downstream effective area outside its own cell (upstream
    ``upscale.py:291-335``)."""
    subidxs_rep, subidxs_ds = _host(subidxs_rep), _host(subidxs_ds)
    _, subncol = subshape
    nrow, ncol = shape
    idxs_ds = np.full(nrow * ncol, mv, dtype=np.int64)
    idx0 = np.where(subidxs_rep != mv)[0]
    if idx0.size == 0:
        return idxs_ds
    cur = subidxs_rep[idx0].astype(np.int64)
    out = np.full(idx0.size, mv, dtype=np.int64)
    ai = np.arange(idx0.size)
    for _ in range(subidxs_ds.size):
        if not ai.size:
            break
        c = cur[ai]
        sub1 = subidxs_ds[c].astype(np.int64)
        low1 = subidx_2_idx(sub1, subncol, cellsize, ncol)
        hit = (low1 != idx0[ai]) & effective_area(sub1, subncol, cellsize, r_ratio)
        stop = (sub1 == c) | hit
        out[ai[stop]] = low1[stop]
        cur[ai[~stop]] = sub1[~stop]
        ai = ai[~stop]
    idxs_ds[idx0] = out
    return idxs_ds


def _next_outlet_walk(idx0, cur, read_ds, is_stop_extra, out_g, subncol, cellsize, ncol,
                      r_ratio, mv):
    """IHU's outlet -> next outlet walks from the lowres cells ``idx0``
    (their outlet pixels ``cur``): a walk stops at an outlet pixel, a pit or
    where ``is_stop_extra`` (the band's halo) says. A stop in the 3x3
    neighbourhood of the start connects; one outside it, or at a pit that
    is not an outlet, is flagged, and one outside falls back to the walk's
    first effective-area pixel. Returns (next lowres cells, fix flags,
    walks stopped by ``is_stop_extra``)."""
    ea_first = np.full(idx0.size, mv, dtype=np.int64)
    result = np.full(idx0.size, mv, dtype=np.int64)
    fix = np.zeros(idx0.size, dtype=bool)
    n_extra = 0
    ai = np.arange(idx0.size)
    for _ in range(read_ds.size):
        if not ai.size:
            break
        c = cur[ai]
        sub1 = read_ds(c)
        low1 = subidx_2_idx(sub1, subncol, cellsize, ncol)
        at_outlet = out_g[low1] == sub1
        extra = is_stop_extra(sub1)
        stop = at_outlet | (sub1 == c) | extra
        ea = effective_area(sub1, subncol, cellsize, r_ratio)
        take = (ea_first[ai] == mv) & ea & ~stop
        ea_first[ai[take]] = sub1[take]
        si = ai[stop]
        n_extra += int(extra.sum())
        d8ok = in_d8(idx0[si], low1[stop], ncol) & ~extra[stop]
        result[si] = np.where(d8ok, sub1[stop], ea_first[si])
        fix[si] |= ~d8ok
        fix[si] |= d8ok & ~at_outlet[stop]
        cur[ai[~stop]] = sub1[~stop]
        ai = ai[~stop]
    result = np.where(result == mv, ea_first, result)
    good = result != mv
    vals = np.full(idx0.size, mv, dtype=np.int64)
    vals[good] = subidx_2_idx(result[good], subncol, cellsize, ncol)
    return vals, fix, n_extra


class _Reader:
    """``ds[c]`` as int64 of a (possibly memory-mapped) window of the
    pixels starting at ``off``; ``size`` bounds the walk."""

    def __init__(self, ds, off=0):
        self.ds, self.off, self.size = ds, off, ds.size

    def __call__(self, c):
        return self.ds[c - self.off].astype(np.int64)


def ihu_nextidx(subidxs_out, subidxs_ds, subshape, shape, cellsize, r_ratio=0.5, mv=_MV):
    """IHU next lowres cell: each outlet pixel traced to the next outlet
    pixel; a connection outside the 3x3 neighbourhood (or to a pit that is
    not an outlet) is flagged for repair, and an outside one falls back to
    the first effective-area pixel (upstream ``upscale.py:437-496``).
    Returns (next cells, flagged cells)."""
    subidxs_out, subidxs_ds = _host_i64(subidxs_out), _host(subidxs_ds)
    _, subncol = subshape
    nrow, ncol = shape
    idxs_ds = np.full(nrow * ncol, mv, dtype=np.int64)
    idx0 = np.where(subidxs_out != mv)[0]
    if idx0.size == 0:
        return idxs_ds, np.array([], dtype=np.int64)
    vals, fix, _ = _next_outlet_walk(
        idx0, subidxs_out[idx0].copy(), _Reader(subidxs_ds), lambda s: np.zeros(s.size, bool),
        subidxs_out, subncol, cellsize, ncol, r_ratio, mv)
    idxs_ds[idx0] = vals
    return idxs_ds, idx0[fix].astype(np.int64)


def upscale_error(subidxs_out, idxs_ds, subidxs_ds, mv=_MV):
    """Connection validity of the upscaled cells (upstream
    ``upscale.py:1312-1363``): uint8 1 ok, 0 error, 255 missing, and the
    cells in error. Each outlet pixel is walked to the next outlet pixel or
    pit, which must be the outlet of its downstream cell."""
    subidxs_out, idxs_ds = _host_i64(subidxs_out), _host_i64(idxs_ds)
    subidxs_ds = _host(subidxs_ds)
    if subidxs_out.size != idxs_ds.size:
        raise ValueError("subidxs_out and idxs_ds must hold one value per lowres cell")
    outlets = np.zeros(subidxs_ds.size, dtype=bool)
    outlets[subidxs_out[subidxs_out != mv]] = True
    connect_map = np.full(idxs_ds.size, 1, np.uint8)
    missing = (idxs_ds == mv) | (subidxs_out == mv)
    connect_map[missing] = 255
    idx0 = np.where(~missing)[0]
    if idx0.size == 0:
        return connect_map, np.array([], dtype=np.int64)
    cur = subidxs_out[idx0].copy()
    bad = np.zeros(idx0.size, dtype=bool)
    ai = np.arange(idx0.size)
    for _ in range(subidxs_ds.size):
        if not ai.size:
            break
        c = cur[ai]
        sub1 = subidxs_ds[c].astype(np.int64)
        stop = outlets[sub1] | (sub1 == c)
        si = ai[stop]
        bad[si] = sub1[stop] != subidxs_out[idxs_ds[idx0[si]]]
        cur[ai[~stop]] = sub1[~stop]
        ai = ai[~stop]
    connect_map[idx0[bad]] = 0
    return connect_map, idx0[bad]


def upscale_check(subidxs_out, idxs_ds, subidxs_ds, minlen=0, mv=_MV):
    """The sub-grid stream map, validity and short / erroneous cells
    (upstream ``upscale.py:1366-1398``): returns (valid, streams, cells in
    error, short cells). ``streams`` (int32, a value a pixel) holds each
    outlet pixel's lowres cell, -1 on the pixels walked over between
    outlets and -9 elsewhere; a connection of at most ``minlen`` steps is
    short."""
    subidxs_out, idxs_ds = _host_i64(subidxs_out), _host_i64(idxs_ds)
    subidxs_ds = _host(subidxs_ds)
    streams = np.full(subidxs_ds.size, -9, dtype=np.int32)
    valid = np.ones(idxs_ds.size, dtype=bool)
    sel = np.where(subidxs_out != mv)[0]
    streams[subidxs_out[sel]] = sel
    idx0s = np.where(idxs_ds != mv)[0]
    cur = subidxs_out[idx0s].copy()
    d = np.zeros(idx0s.size, dtype=np.int64)
    bad = np.zeros(idx0s.size, dtype=bool)
    short = np.zeros(idx0s.size, dtype=bool)
    ai = np.arange(idx0s.size)
    for _ in range(subidxs_ds.size):
        if not ai.size:
            break
        c = cur[ai]
        sub1 = subidxs_ds[c].astype(np.int64)
        stop = (streams[sub1] >= 0) | (sub1 == c)
        si = ai[stop]
        tgt = subidxs_out[idxs_ds[idx0s[si]]]
        bad[si] = sub1[stop] != tgt
        short[si] = (sub1[stop] == tgt) & (minlen > 0) & (d[si] + 1 <= minlen)
        # mark the pixels walked over (not the ones a walk stops at)
        go = ai[~stop]
        streams[cur[go]] = np.maximum(streams[cur[go]], -1)
        d[go] += 1
        cur[go] = sub1[~stop]
        ai = go
    valid[idx0s[bad]] = False
    return valid, streams, idx0s[bad], idx0s[short]


# ---------------------------------------------------------------------------
# IHU repairs (native host library)
# ---------------------------------------------------------------------------


class _Repair:
    """What the IHU repairs read, converted once: the highres downstream
    pixels as int64 and the upstream area as float64 for the native
    library, and the upstream area as the caller gave it, the sort key of
    the JAX package's ``np.argsort`` (numpy's default sort is not stable;
    another dtype may order ties otherwise). Memory-mapped inputs of those
    dtypes stay mapped."""

    def __init__(self, subidxs_ds, subuparea, subshape, shape, cellsize):
        self.ds = np.ascontiguousarray(_host(subidxs_ds), dtype=np.int64)
        self.key = _host(subuparea)
        self.upa = np.ascontiguousarray(self.key, dtype=np.float64)
        self.dims = (shape, subshape[1], cellsize)

    def relocate(self, broken, cell_ds, cell_out):
        from .runtime import ihu_relocate

        broken = _host_i64(broken)
        # ascending outlet uparea
        broken = broken[np.argsort(self.key[cell_out[broken]])]
        return ihu_relocate(cell_ds, cell_out, self.ds, self.upa, broken, *self.dims)

    def opt_rivlen(self, short, valid, strm, cell_ds, cell_out, minlen, minupa):
        from .runtime import ihu_opt_rivlen

        ihu_opt_rivlen(cell_ds, cell_out, strm, valid, self.ds, self.upa, short, *self.dims,
                       minlen, minupa)

    def min_error(self, broken, valid, strm, cell_ds, cell_out, minlen, minupa, pit_out):
        from .runtime import ihu_min_error

        broken = _host_i64(broken)
        # descending outlet uparea
        broken = broken[np.argsort(self.key[cell_out[broken]])[::-1]]
        ihu_min_error(cell_ds, cell_out, strm, valid, self.ds, self.upa, broken, *self.dims,
                      minlen, minupa, pit_out)


def _copies(idxs_ds, subidxs_out):
    return np.array(_host(idxs_ds), dtype=np.int64), np.array(_host(subidxs_out), dtype=np.int64)


def ihu_relocate_outlets(idxs_fix, idxs_ds, subidxs_out, subidxs_ds, subuparea, subshape, shape,
                         cellsize, mv=_MV):
    """Relocate outlet pixels to reconnect the disconnected cells
    ``idxs_fix`` (None: those of :func:`upscale_error`); upstream
    ``upscale.py:522-877``, the native ``ihu_relocate``. Returns new
    (idxs_ds, subidxs_out, cells still broken)."""
    if idxs_fix is None:
        idxs_fix = upscale_error(subidxs_out, idxs_ds, subidxs_ds, mv=mv)[1]
    cell_ds, cell_out = _copies(idxs_ds, subidxs_out)
    rep = _Repair(subidxs_ds, subuparea, subshape, shape, cellsize)
    still = rep.relocate(idxs_fix, cell_ds, cell_out)
    return cell_ds, cell_out, still


def ihu_optimize_rivlen(idxs_short, valid, streams, idxs_ds, subidxs_out, subidxs_ds, subuparea,
                        subshape, shape, cellsize, minlen=0, minupa=0, mv=_MV):
    """Shorten the cells whose sub-grid river to the next outlet is too
    short (upstream ``upscale.py:971-1019``, the native
    ``ihu_opt_rivlen``); ``streams`` is updated in place (the next pass
    reads it). Returns new (idxs_ds, subidxs_out)."""
    cell_ds, cell_out = _copies(idxs_ds, subidxs_out)
    rep = _Repair(subidxs_ds, subuparea, subshape, shape, cellsize)
    rep.opt_rivlen(idxs_short, valid, streams, cell_ds, cell_out, minlen, minupa)
    return cell_ds, cell_out


def ihu_minimize_error(idxs_fix, valid, streams, idxs_ds, subidxs_out, subidxs_ds, subuparea,
                       subshape, shape, cellsize, minlen=0, minupa=0, pit_out_of_cell=2,
                       mv=_MV):
    """Reduce the cells with upstream-area errors (upstream
    ``upscale.py:1022-1152``, the native ``ihu_min_error``). Returns new
    (idxs_ds, subidxs_out)."""
    cell_ds, cell_out = _copies(idxs_ds, subidxs_out)
    rep = _Repair(subidxs_ds, subuparea, subshape, shape, cellsize)
    rep.min_error(idxs_fix, valid, streams, cell_ds, cell_out, minlen, minupa, pit_out_of_cell)
    return cell_ds, cell_out


def _ihu_rounds(idxs_ds, subidxs_out, broken, rep, cellsize, minlen_ratio, minupa_ratio, niter,
                opt_rivlen, min_error, pit_out_of_cell, mv):
    """Up to ``niter`` repair rounds: relocate the broken cells, check the
    connections, shorten short reaches, reduce the upstream-area errors;
    the round that fixes nothing new is the last, and only the last allows
    pits near the cell (``pit_out_of_cell``). The arrays are repaired in
    place."""
    min_reach_len = cellsize * minlen_ratio
    min_outlet_upa = cellsize**2 * minupa_ratio
    for round_no in range(niter):
        rep.relocate(broken, idxs_ds, subidxs_out)
        valid, strm, still_broken, short = upscale_check(
            subidxs_out, idxs_ds, rep.ds, minlen=min_reach_len, mv=mv)
        final = still_broken.size in (0, broken.size) or round_no + 1 == niter
        valid = valid.astype(np.uint8)
        if opt_rivlen:
            rep.opt_rivlen(short, valid, strm, idxs_ds, subidxs_out, min_reach_len,
                           min_outlet_upa)
        if min_error:
            rep.min_error(still_broken, valid, strm, idxs_ds, subidxs_out, min_reach_len,
                          min_outlet_upa, pit_out_of_cell if final else 0)
        if final:
            break
        broken = still_broken
    return idxs_ds, subidxs_out


def _upscale_inputs(subidxs_ds, subuparea, device):
    """The highres grid on the host (int64) and on ``device`` (int64 and
    float64 upstream area), each copied once."""
    dev = resolve_device(device)
    ds_np = _host_i64(subidxs_ds)
    return dev, ds_np, torch.as_tensor(ds_np, device=dev), _dev(subuparea, dev).to(torch.float64)


def dmm(subidxs_ds, subuparea, subshape, cellsize, mv=_MV, device=None):
    """Double maximum method (upstream ``upscale.py:172-208``): returns
    (lowres idxs_ds, exit pixels, lowres shape)."""
    dev, ds_np, ds, upa = _upscale_inputs(subidxs_ds, subuparea, device)
    shape = _lowres_shape(subshape, cellsize)
    out = dmm_exitcell(ds, upa, subshape, shape, cellsize, mv=mv, device=dev)
    return dmm_nextidx(out, ds_np, subshape, shape, cellsize, mv), out, shape


def eam(subidxs_ds, subuparea, subshape, cellsize, r_ratio=0.5, mv=_MV, device=None):
    """Effective area method (upstream ``upscale.py:338-376``): returns
    (lowres idxs_ds, representative pixels, lowres shape)."""
    dev, ds_np, ds, upa = _upscale_inputs(subidxs_ds, subuparea, device)
    shape = _lowres_shape(subshape, cellsize)
    rep = eam_repcell(ds, upa, subshape, shape, cellsize, r_ratio, mv=mv, device=dev)
    return eam_nextidx(rep, ds_np, subshape, shape, cellsize, r_ratio, mv), rep, shape


def ihu(subidxs_ds, subuparea, subshape, cellsize, minlen_ratio=0.25, minupa_ratio=0.25,
        r_ratio=0.5, niter=5, opt_rivlen=True, min_error=True, pit_out_of_cell=2, mv=_MV,
        device=None):
    """Iterative hydrography upscaling (upstream ``upscale.py:1155-1305``).
    Construction: the EAM representative pixels and the outlet trace on
    ``device``, the outlet -> outlet walks on the host; then up to
    ``niter`` rounds of the native repairs. The highres grid is copied to
    the device and converted for the repairs once a call. Returns (lowres
    idxs_ds, outlet pixels, lowres shape)."""
    dev, ds_np, ds, upa = _upscale_inputs(subidxs_ds, subuparea, device)
    shape = _lowres_shape(subshape, cellsize)
    geo = dict(subshape=subshape, shape=shape, cellsize=cellsize, mv=mv)
    rep = eam_repcell(ds, upa, r_ratio=r_ratio, device=dev, **geo)
    subidxs_out = ihu_outlets(rep, ds, upa, device=dev, **geo)
    del ds, upa
    idxs_ds, broken = ihu_nextidx(subidxs_out, ds_np, r_ratio=r_ratio, **geo)
    repair = _Repair(ds_np, subuparea, subshape, shape, cellsize)
    idxs_ds, subidxs_out = _ihu_rounds(idxs_ds, subidxs_out, broken, repair, cellsize,
                                       minlen_ratio, minupa_ratio, niter, opt_rivlen, min_error,
                                       pit_out_of_cell, mv)
    return idxs_ds, subidxs_out, shape


def eam_plus(subidxs_ds, subuparea, subshape, cellsize, mv=_MV, device=None):
    """EAM+: IHU without repair rounds (upstream ``upscale.py:1308-1309``)."""
    return ihu(subidxs_ds, subuparea, subshape, cellsize, niter=0, mv=mv, device=device)


# ---------------------------------------------------------------------------
# banded IHU: continental mosaics within bounded host memory
# ---------------------------------------------------------------------------


def _ihu_construct_banded(subidxs_ds, subuparea, subshape, shape, cellsize, r_ratio, mv,
                          band_rows, halo_rows, dev):
    """IHU's construction over bands of ``band_rows`` lowres rows. The
    representative pixels and outlet traces stay in their lowres cell, so
    the bands need no halo there (each band's maps and ``reach`` run on
    ``dev``); the outlet -> outlet walks end at most one lowres ring away
    for a valid connection, and get ``halo_rows`` rings. A walk that leaves
    the halo is flagged for repair (the repairs may resolve it otherwise
    than :func:`ihu`), counted and warned about. ``subidxs_ds`` /
    ``subuparea`` may be memory-mapped: one band and its halo are read at
    a time."""
    subnrow, subncol = subshape
    nrow, ncol = shape
    nlow = nrow * ncol
    out_g = np.full(nlow, mv, dtype=np.int64)
    ea_tab = _cell_table(_effare_rc, cellsize, dev, r_ratio)

    # pass 1: representative and outlet pixels, band by band, on the device
    for b0 in range(0, nrow, band_rows):
        b1 = min(b0 + band_rows, nrow)
        r0, r1 = b0 * cellsize, min(b1 * cellsize, subnrow)
        off = r0 * subncol
        sds = torch.as_tensor(np.asarray(subidxs_ds[off : r1 * subncol], dtype=np.int64),
                              device=dev)
        supa = torch.as_tensor(np.asarray(subuparea[off : r1 * subncol]), device=dev)
        px = _Pixels(sds.shape[0], off, subncol, cellsize, ncol, dev)
        lo0, lo1 = b0 * ncol, b1 * ncol
        rep = _repcell(sds, supa.to(torch.float64), px, ea_tab, lo1 - lo0, lo0, mv)
        t = _outlet_trace(sds, px, mv)
        out = torch.where(rep != mv, t[(rep - off).clamp(min=0)], rep)
        out_g[lo0:lo1] = out.cpu().numpy()

    # pass 2: outlet -> next outlet walks with a halo of lowres rings
    idxs_ds = np.full(nlow, mv, dtype=np.int64)
    fix_all = []
    n_escaped = 0
    for b0 in range(0, nrow, band_rows):
        b1 = min(b0 + band_rows, nrow)
        h0 = max(b0 - halo_rows, 0) * cellsize
        h1 = min((b1 + halo_rows) * cellsize, subnrow)
        off, hi = h0 * subncol, h1 * subncol
        lo0, lo1 = b0 * ncol, b1 * ncol
        idx0 = lo0 + np.where(out_g[lo0:lo1] != mv)[0]
        if idx0.size == 0:
            continue
        sds = np.asarray(subidxs_ds[off:hi], dtype=np.int64)
        vals, fix, esc = _next_outlet_walk(
            idx0, out_g[idx0].copy(), _Reader(sds, off), lambda s: (s < off) | (s >= hi),
            out_g, subncol, cellsize, ncol, r_ratio, mv)
        n_escaped += esc
        idxs_ds[idx0] = vals
        fix_all.append(idx0[fix])

    if n_escaped:
        warnings.warn(
            f"{n_escaped} outlet walk(s) left the {halo_rows}-row halo and were flagged for "
            "repair; raise halo_rows to match the monolithic IHU on these cells"
        )
    idxs_fix = np.concatenate(fix_all) if fix_all else np.array([], dtype=np.int64)
    return idxs_ds, out_g, idxs_fix


def ihu_tiled(subidxs_ds, subuparea, subshape, cellsize, band_rows=64, halo_rows=4,
              minlen_ratio=0.25, minupa_ratio=0.25, r_ratio=0.5, niter=5, opt_rivlen=True,
              min_error=True, pit_out_of_cell=2, mv=_MV, device=None):
    """Out-of-core IHU for continental mosaics: :func:`ihu` with the
    highres construction streamed over bands of ``band_rows`` lowres rows
    (``halo_rows`` rings for the walks between cells). Pass ``subidxs_ds``
    as an int64 ``np.memmap`` and ``subuparea`` as a float64 one: one band
    at a time is read and sent to ``device``; the repair rounds run on the
    lowres arrays and page into the maps."""
    dev = resolve_device(device)
    shape = _lowres_shape(subshape, cellsize)
    idxs_ds, subidxs_out, broken = _ihu_construct_banded(
        subidxs_ds, subuparea, subshape, shape, cellsize, r_ratio, mv, band_rows, halo_rows, dev)
    repair = _Repair(subidxs_ds, subuparea, subshape, shape, cellsize)
    idxs_ds, subidxs_out = _ihu_rounds(idxs_ds, subidxs_out, broken, repair, cellsize,
                                       minlen_ratio, minupa_ratio, niter, opt_rivlen, min_error,
                                       pit_out_of_cell, mv)
    return idxs_ds, subidxs_out, shape
