"""Unit catchments and sub-grid river statistics (upstream pyflwdir
``subgrid.py``).

The unit-catchment maps and sums run on the device: each pixel's label is
that of the first outlet at or below it (one pointer-doubling ``reach``),
and the sums group by label, integers by ``index_add_`` (exact in any
order), floats by ``graph._sum_by_target`` in an order fixed by the data
(the same bits from call to call, on the CPU and the card). The segment
statistics walk between outlet pixels in the native host library
(``runtime.channel_paths`` / ``fixed_windows``) and reduce in numpy, as
the JAX package does: their results are the JAX package's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import upscale as upscale_mod
from ._backend import resolve_device

__all__ = [
    "outlets",
    "ucat_area",
    "ucat_volume",
    "segment_length",
    "segment_average",
    "segment_median",
    "segment_indices",
    "segment_slope",
    "fixed_length_slope",
]

_MV = -1


def outlets(idxs_ds, uparea, cellsize, shape, method="eam_plus", mv=_MV, device=None):
    """Unit-catchment outlet pixels of the lowres cells of ``cellsize``
    (upstream ``subgrid.py:13-48``): the DMM exit pixels, or the EAM+
    outlet pixels (representative pixel traced to its cell's edge). Maps on
    ``device``; returns (int64 outlets, lowres shape)."""
    nrow, ncol = shape
    shape_out = (int(np.ceil(nrow / cellsize)), int(np.ceil(ncol / cellsize)))
    dev = resolve_device(device)
    ds = upscale_mod._dev(idxs_ds, dev).to(torch.int64)
    upa = upscale_mod._dev(uparea, dev).to(torch.float64)
    args = (ds, upa, shape, shape_out, cellsize)
    if method.lower() == "dmm":
        idxs_out = upscale_mod.dmm_exitcell(*args, mv=mv, device=dev)
    elif method.lower() == "eam_plus":
        idxs_rep = upscale_mod.eam_repcell(*args, mv=mv, device=dev)
        idxs_out = upscale_mod.ihu_outlets(idxs_rep, *args, mv=mv, device=dev)
    else:
        raise ValueError(f'Method {method} unknown, choose from ["eam_plus", "dmm"]')
    return idxs_out, shape_out


def _labels(idxs_out, ds, mv):
    """Each pixel's unit catchment: 1 + the position in ``idxs_out`` of the
    first outlet at or below it, 0 where there is none or the pixel is
    missing (int64, on ``ds``' device)."""
    from .ops import graph

    n, dev = ds.shape[0], ds.device
    out = torch.as_tensor(np.asarray(idxs_out, dtype=np.int64).ravel(), device=dev)
    has = out != mv
    cells = out[has]
    label = torch.zeros(n, dtype=torch.int64, device=dev)
    label[cells] = torch.nonzero(has).ravel() + 1
    stop = torch.zeros(n, dtype=torch.bool, device=dev)
    stop[cells] = True
    t = graph.reach(ds, stop)
    ucat = torch.where((ds >= 0) & stop[t], label[t], torch.zeros_like(label))
    return ucat, has


def _group_sum(ucat, vals, m):
    """``out[k]`` sums ``vals`` over the pixels of unit catchment k + 1:
    integers by ``index_add_``, floats by ``graph._sum_by_target``."""
    from .ops import graph

    tgt = torch.where(ucat > 0, ucat - 1, torch.full_like(ucat, m))
    if vals.dtype.is_floating_point:
        return graph._sum_by_target(tgt, vals, m)
    base = torch.zeros(m + 1, dtype=vals.dtype, device=vals.device)
    return base.index_add_(0, tgt, vals)[:m]


def ucat_area(idxs_out, idxs_ds, area, mv=_MV, device=None):
    """Unit-catchment map and the area of each catchment (upstream
    ``subgrid.py:52-93``), on ``device``: returns (int64 label map, the
    sums of ``area`` in its dtype, -9999 at missing outlets) as tensors."""
    dev = resolve_device(device)
    ds = upscale_mod._dev(idxs_ds, dev).to(torch.int64)
    area = upscale_mod._dev(area, dev)
    ucat, has = _labels(idxs_out, ds, mv)
    sums = _group_sum(ucat, area, has.numel())
    return ucat, torch.where(has, sums, torch.full_like(sums, -9999))


def ucat_volume(idxs_out, idxs_ds, hand, area, depths=None, mv=_MV, device=None):
    """Unit-catchment map and flood-volume profile (upstream
    ``subgrid.py:97-142``), on ``device``: the volume at depth d sums
    ``area * max(0, d - hand)`` over the catchment. Each term takes the
    JAX package's dtypes (``d - hand`` in the promoted type of the two,
    then times ``area``) and is cast to float32 before the float32 sum. Returns
    (int64 label map, (len(depths), m) volumes in ``depths``' dtype, -9999
    at missing outlets) as tensors."""
    if depths is None:
        depths = np.arange(0.5, 3.0, 0.5, dtype=np.float32)
    depths = np.asarray(depths)
    dev = resolve_device(device)
    ds = upscale_mod._dev(idxs_ds, dev).to(torch.int64)
    hand = upscale_mod._dev(hand, dev)
    area = upscale_mod._dev(area, dev)
    ucat, has = _labels(idxs_out, ds, mv)
    in_ucat = ucat > 0
    dt_d = torch.from_numpy(depths).dtype
    dt_h = torch.promote_types(dt_d, hand.dtype)  # d - hand
    dt_v = torch.promote_types(area.dtype, dt_h)  # area * max(0, d - hand)
    vols = []
    for d in depths:
        h = (torch.tensor(d, dtype=dt_h, device=dev) - hand.to(dt_h)).clamp(min=0)
        dv = area.to(dt_v) * h.to(dt_v)
        dv = torch.where(in_ucat, dv, torch.zeros_like(dv)).to(torch.float32)
        s = _group_sum(ucat, dv, has.numel())
        vols.append(torch.where(has, s, torch.full_like(s, -9999.0)))
    return ucat, torch.stack(vols).to(dt_d)


def _segment_csr(idxs_out, idxs_nxt, mask=None, max_len=0, include_outlet=False):
    """The channel walks between the outlet pixels, in CSR form
    (``runtime.channel_paths``)."""
    from .runtime import channel_paths

    return channel_paths(
        np.asarray(idxs_nxt),
        np.asarray(idxs_out),
        mask=None if mask is None else np.asarray(mask),
        max_len=max_len,
        include_outlet=include_outlet,
    )


def _ols_slope(n, sx, sy, sxy, sxx):
    """Least-squares slope from each segment's moment sums (the closed form
    of :func:`pyflwdir_torch.arithmetics.lstsq`), 0 where it is singular."""
    denom = n * sxx - sx * sx
    return np.divide(n * sxy - sx * sy, denom, out=np.zeros_like(denom), where=denom != 0)


def _moments(seg, x, y, m):
    return [np.bincount(seg, weights=w, minlength=m) for w in (x, y, x * y, x * x)]


def segment_length(idxs_out, idxs_nxt, distnc, mask=None, nodata=-9999.0, mv=_MV):
    """Channel length of each outlet's segment (upstream
    ``subgrid.py:146-205``): the |distnc| difference between the outlet and
    the walk's last pixel (the next outlet, included); ``nodata`` where the
    walk is empty."""
    idxs_out = np.asarray(idxs_out)
    distnc = np.asarray(distnc)
    off, data, _, _ = _segment_csr(idxs_out, idxs_nxt, mask, include_outlet=True)
    rivlen = np.full(idxs_out.size, nodata, dtype=distnc.dtype)
    has = off[1:] > off[:-1]
    last = data[np.maximum(off[1:] - 1, 0)]
    first = data[np.minimum(off[:-1], data.size - 1 if data.size else 0)]
    rivlen[has] = np.abs(distnc[last[has]] - distnc[first[has]])
    return rivlen


def segment_average(idxs_out, idxs_nxt, data, weights, mask=None, nodata=-9999.0, mv=_MV):
    """Weighted mean of ``data`` over each segment, nodata left out
    (upstream ``subgrid.py:208-272``): float64 sums by ``np.bincount``, cast
    to ``data``'s dtype."""
    idxs_out = np.asarray(idxs_out)
    data = np.asarray(data)
    off, pix, _, _ = _segment_csr(idxs_out, idxs_nxt, mask)
    out = np.full(idxs_out.size, nodata, dtype=data.dtype)
    nan = isinstance(nodata, float) and np.isnan(nodata)
    counts = np.diff(off)
    seg = np.repeat(np.arange(idxs_out.size), counts)
    vals = data[pix].astype(np.float64)
    w = np.asarray(weights)[pix].astype(np.float64)
    good = ~(np.isnan(vals) if nan else (vals == nodata))
    wsum = np.bincount(seg[good], weights=w[good], minlength=idxs_out.size)
    vsum = np.bincount(seg[good], weights=(vals * w)[good], minlength=idxs_out.size)
    ok = (counts > 0) & (wsum != 0)
    out[ok] = (vsum[ok] / wsum[ok]).astype(data.dtype)
    return out


def segment_median(idxs_out, idxs_nxt, data, weights=None, mask=None, nodata=-9999.0, mv=_MV):
    """Median of ``data`` over each segment, nodata and NaN left out
    (upstream ``subgrid.py:276-337``): one grouped sort, the midpoint of
    the two middle values."""
    idxs_out = np.asarray(idxs_out)
    data = np.asarray(data)
    off, pix, _, _ = _segment_csr(idxs_out, idxs_nxt, mask)
    out = np.full(idxs_out.size, nodata, dtype=data.dtype)
    counts = np.diff(off)
    seg = np.repeat(np.arange(idxs_out.size), counts)
    vals = data[pix].astype(np.float64)
    good = ~(np.isnan(vals) | (vals == nodata))
    seg, vals = seg[good], vals[good]
    if seg.size == 0:
        return out
    order = np.lexsort((vals, seg))
    seg, vals = seg[order], vals[order]
    k = np.bincount(seg, minlength=idxs_out.size)
    starts = np.concatenate([[0], np.cumsum(k)[:-1]])
    ok = k > 0
    lo = starts[ok] + (k[ok] - 1) // 2
    hi = starts[ok] + k[ok] // 2
    out[ok] = ((vals[lo] + vals[hi]) / 2.0).astype(data.dtype)
    return out


def segment_indices(idxs_out, idxs_nxt, mask=None, max_len=0, mv=_MV):
    """The pixels of each segment between outlet pixels, a list of int64
    arrays (upstream ``subgrid.py:341-410``): segments of one pixel are
    left out, and a walk that ends at a pit adds a ``[pit, pit]`` stub."""
    idxs_out = np.asarray(idxs_out)
    off, pix, ends, kinds = _segment_csr(idxs_out, idxs_nxt, mask, max_len=max_len,
                                         include_outlet=True)
    segments = []
    for i in range(idxs_out.size):
        row = pix[off[i] : off[i + 1]]
        if row.size > 1:
            segments.append(row)
        if kinds[i] == 2:  # ended at a pit
            segments.append(np.array([ends[i], ends[i]], dtype=np.int64))
    return segments


def segment_slope(idxs_out, idxs_nxt, elevtn, distnc, mask=None, nodata=-9999.0, lstsq=True,
                  mv=_MV):
    """Slope over each segment, least squares or between its ends
    (upstream ``subgrid.py:414-485``): 0 for a one-pixel segment,
    ``nodata`` for an empty one."""
    idxs_out = np.asarray(idxs_out)
    elevtn, distnc = np.asarray(elevtn), np.asarray(distnc)
    off, pix, _, _ = _segment_csr(idxs_out, idxs_nxt, mask)
    out = np.full(idxs_out.size, nodata, dtype=elevtn.dtype)
    counts = np.diff(off)
    out[counts == 1] = 0.0
    multi = counts > 1
    if not multi.any():
        return out
    if lstsq:
        seg = np.repeat(np.arange(idxs_out.size), counts)
        x = distnc[pix].astype(np.float64)
        y = elevtn[pix].astype(np.float64)
        slope = _ols_slope(counts.astype(np.float64), *_moments(seg, x, y, idxs_out.size))
        out[multi] = np.abs(slope[multi]).astype(elevtn.dtype)
    else:
        first = pix[off[:-1][multi]]
        last = pix[off[1:][multi] - 1]
        dz = elevtn[first] - elevtn[last]
        dx = distnc[first] - distnc[last]
        out[multi] = np.abs(dz / dx).astype(elevtn.dtype)
    return out


def fixed_length_slope(idxs_out, idxs_ds, idxs_us_main, elevtn, distnc, length=1e3, mask=None,
                       lstsq=True, mv=_MV):
    """Channel slope over a main-stem window of about ``length`` centred on
    each outlet pixel (upstream ``subgrid.py:488-559``), least squares or
    between the window's ends; float32, -9999 for an empty window."""
    from .runtime import fixed_windows

    idxs_out = np.asarray(idxs_out)
    distnc = np.asarray(distnc)
    off, pix = fixed_windows(
        np.asarray(idxs_ds),
        np.asarray(idxs_us_main),
        np.asarray(distnc, dtype=np.float64),
        idxs_out,
        float(length),
        mask=None if mask is None else np.asarray(mask),
    )
    out = np.full(idxs_out.size, -9999.0, dtype=np.float32)
    counts = np.diff(off)
    out[counts == 1] = 0.0
    multi = counts > 1
    if not multi.any():
        return out
    x = distnc[pix].astype(np.float64)
    y = np.asarray(elevtn)[pix].astype(np.float64)
    if lstsq:
        seg = np.repeat(np.arange(idxs_out.size), counts)
        slope = _ols_slope(counts.astype(np.float64), *_moments(seg, x, y, idxs_out.size))
        out[multi] = np.abs(slope[multi]).astype(np.float32)
    else:
        first = off[:-1][multi]
        last = off[1:][multi] - 1
        out[multi] = np.abs((y[first] - y[last]) / (x[first] - x[last])).astype(np.float32)
    return out
