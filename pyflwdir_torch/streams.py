"""Stream maps over the flow network: upstream and downstream accumulation,
upstream area, stream order, distance to the outlet, river-length smoothing
and stream segments. The maps run by pointer doubling
(:mod:`pyflwdir_torch.ops.graph`, :mod:`pyflwdir_torch.ops.order`) on
tensors; the sequential river-length smoothing and the segment assembly run
in the native host library and take and return numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

from .ops import graph
from .ops.order import classic_order, strahler_order
from .utils import geodesy
from .utils.affine import IDENTITY

__all__ = [
    "accuflux",
    "accuflux_ds",
    "upstream_area",
    "stream_order",
    "strahler_order",
    "stream_distance",
    "streams",
    "smooth_rivlen",
]


def accuflux(idxs_ds, data, nodata=-9999, tree=None):
    """Accumulated upstream ``data``; nodata cells stay nodata and cut the
    flow from their subtree (:func:`pyflwdir_torch.ops.graph.accumulate`)."""
    return graph.accumulate(idxs_ds, data, tree=tree, nodata=nodata)


def accuflux_ds(idxs_ds, data, nodata=-9999):
    """Accumulated downstream ``data``: the sum over each cell's path to its
    pit; nodata cells stay nodata and cut the paths above them."""
    return graph.accumulate_downstream(idxs_ds, data, nodata=nodata)


def upstream_area(idxs_ds, area, nodata=-9999.0, tree=None):
    """Upstream sum of the per-cell ``area`` (dense, e.g. from
    :func:`pyflwdir_torch.utils.geodesy.area_grid`); ``nodata`` at missing
    cells. In ``area``'s dtype where it is a float, else float64."""
    uparea = graph.accumulate(idxs_ds, area, tree=tree)
    if not uparea.dtype.is_floating_point:
        uparea = uparea.to(torch.float64)
    return torch.where(idxs_ds >= 0, uparea, torch.full_like(uparea, nodata))


def stream_order(idxs_ds, idxs_us_main, mask=None):
    """Classic (Hack) stream order (:func:`pyflwdir_torch.ops.order.classic_order`)."""
    return classic_order(idxs_ds, idxs_us_main, mask=mask)


def stream_distance(
    idxs_ds,
    shape,
    mask=None,
    real_length=True,
    latlon=False,
    transform=IDENTITY,
    edge_length=None,
):
    """Distance to the outlet, or to the next downstream True cell of
    ``mask`` (such cells are at distance 0): float32 metres, or int32 cells
    where not ``real_length``; -9999 at missing cells."""
    n = idxs_ds.shape[0]
    if real_length:
        if edge_length is None:
            edge_length = torch.as_tensor(
                np.asarray(
                    geodesy.distance_grid(
                        idxs_ds.cpu().numpy(), shape, latlon=latlon, transform=transform
                    ),
                    dtype=np.float32,
                ).ravel(),
                device=idxs_ds.device,
            )
        w = edge_length.to(torch.float32)
    else:
        w = torch.ones(n, dtype=torch.int32, device=idxs_ds.device)
    dist = graph.path_sum(idxs_ds, w, stop=mask)
    return torch.where(idxs_ds >= 0, dist, torch.full_like(dist, -9999))


def smooth_rivlen(idxs_ds, idxs_us_main, rivlen, min_rivlen, max_window=10, nodata=-9999.0):
    """River lengths below ``min_rivlen`` smoothed over a growing window along
    the main stem. Each cell, in index order, sees the changes made at the
    cells before it, so the sweep is sequential and runs in the native host
    library (``runtime.smooth_rivlen``). Numpy in and out, ``rivlen``'s
    dtype."""
    from .runtime import smooth_rivlen as _native

    rivlen = np.asarray(rivlen)
    out = _native(np.asarray(idxs_ds), np.asarray(idxs_us_main), rivlen, min_rivlen,
                  max_window, nodata)
    return out.astype(rivlen.dtype)


def streams(idxs_ds_np, rank_np, nup_np, mask=None, max_len=0):
    """Stream segments as a list of arrays of linear indices, each up- to
    downstream from a segment head to the next confluence or pit; segments
    longer than ``max_len`` are split and a one-cell stub closes each pit
    (``runtime.stream_segments``). Heads go up- to downstream: by decreasing
    rank, ties by index."""
    from .runtime import stream_segments as _native

    idxs_ds_np = np.asarray(idxs_ds_np)
    rank_np = np.asarray(rank_np).ravel()
    valid = rank_np >= 0
    heads = np.where(valid)[0][np.argsort(-rank_np[valid], kind="stable")]
    seg_off, data = _native(idxs_ds_np, heads, np.asarray(nup_np),
                            mask=None if mask is None else np.asarray(mask), max_len=max_len)
    data = data.astype(idxs_ds_np.dtype)
    return [data[seg_off[i]:seg_off[i + 1]] for i in range(seg_off.size - 1)]
