"""Grid tools: the nearest observation spread over a grid, and GeoJSON
LineString features of flow paths, both on the host.

``spread2d`` is the Dijkstra spread of the native host library
(``runtime.spread2d``); ``get_edge`` is :func:`pyflwdir_torch.dem.get_edge`.
"""

from __future__ import annotations

import numpy as np

from . import runtime
from .dem import get_edge
from .utils import geodesy
from .utils.affine import IDENTITY

__all__ = ["spread2d", "features", "get_edge"]


def spread2d(obs, msk=None, nodata=0, frc=None, latlon=False, transform=IDENTITY):
    """Fill a grid with its nearest observations: ``(out, src, dst)``, the
    values, the int32 index of each cell's source and the float32 distance
    to it. The spread runs through the ``msk`` cells, its steps times the
    friction ``frc`` where given; diagonal steps cost the hypotenuse, and a
    latlon grid's degrees are made metres row by row."""
    return runtime.spread2d(
        np.asarray(obs), msk=msk, nodata=nodata, frc=frc, latlon=latlon, transform=transform
    )


def features(flowpaths, xs=None, ys=None, transform=None, shape=None, **properties):
    """One LineString GeoJSON feature dict a flow path of two cells or more:
    the coordinates from ``xs`` / ``ys``, else from ``transform`` and
    ``shape``; properties ``idx`` (the head), ``idx_ds`` (the last cell),
    ``pit`` (the last cell repeated) and each map of ``properties`` sampled
    at the head. The coordinates of all paths come from one vectorised
    call."""
    if xs is None or ys is None:
        if transform is None or shape is None:
            raise ValueError("transform and shape should be provided if xs and ys are None")
        size = shape[0] * shape[1]
    else:
        xs, ys = np.asarray(xs).ravel(), np.asarray(ys).ravel()
        size = xs.size
    for name, arr in properties.items():
        if not isinstance(arr, np.ndarray) or arr.size != size:
            raise ValueError(
                f'Kwargs map "{name}" should be ndarrays of same size as coordinates'
            )

    paths = [p for p in (np.asarray(p) for p in flowpaths) if p.size >= 2]
    if not paths:
        return []
    # every path's coordinates in one call, then sliced per path
    cells = np.concatenate(paths)
    if xs is None or ys is None:
        x, y = geodesy.idxs_to_coords(cells, transform, shape)
    else:
        x, y = xs[cells], ys[cells]
    xl, yl = np.asarray(x).tolist(), np.asarray(y).tolist()
    feats = []
    o0 = 0
    for path in paths:
        o1 = o0 + path.size
        head = path[0]
        props = {"idx": head, "idx_ds": path[-1], "pit": path[-1] == path[-2]}
        props.update({name: arr.flat[head] for name, arr in properties.items()})
        feats.append({
            "type": "Feature",
            "geometry": {"type": "LineString", "coordinates": list(zip(xl[o0:o1], yl[o0:o1]))},
            "properties": props,
        })
        o0 = o1
    return feats
