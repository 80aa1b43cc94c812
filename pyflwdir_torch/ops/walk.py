"""Window gathers and batched walks over the flow network.

``window_indices`` runs on the device: an n-step window is n gathers of
the downstream graph and n of the main upstream cells, one whole-array
gather a step. The walks of variable length (``trace``, ``paths``,
``snap_walk``) run on the host in the native library
(``runtime.trace_walks``), one batched call for all seeds, and return
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import geodesy
from ..utils.affine import IDENTITY
from .graph import self_loop

__all__ = ["window_indices", "trace", "paths", "snap_walk"]


def window_indices(idxs_ds, idxs_us_main, n, strord=None):
    """The window of the ``n`` nearest cells up- and downstream of each cell:
    a ``(2n+1, size)`` int64 tensor whose row ``n`` is the cell itself, rows
    ``n+1 .. 2n`` the cells 1 .. n steps downstream and rows ``n-1 .. 0``
    the 1 .. n steps up the main upstream cells; -1 marks an absent entry.

    With ``strord``, the downstream walk stops before a cell whose stream
    order is above that of the window's own cell (the row ``n`` cell), not
    above that of the cell it steps from."""
    size = idxs_ds.shape[0]
    ar = torch.arange(size, dtype=idxs_ds.dtype, device=idxs_ds.device)
    ds = self_loop(idxs_ds)
    neg = torch.full_like(ar, -1)
    out = torch.empty((2 * n + 1, size), dtype=torch.int64, device=idxs_ds.device)
    out[n] = ar
    cur, stopped = ar, idxs_ds < 0
    for k in range(1, n + 1):
        nxt = ds[cur.clamp(min=0)]
        stop = (nxt == cur) | (cur < 0)
        if strord is not None:
            stop = stop | (strord[nxt.clamp(min=0)] > strord)
        stopped = stopped | stop
        cur = torch.where(stopped, neg, nxt)
        out[n + k] = cur
    cur, stopped = ar, idxs_ds < 0
    for k in range(1, n + 1):
        nxt = torch.where(cur >= 0, idxs_us_main[cur.clamp(min=0)], neg)
        stopped = stopped | (nxt < 0)
        cur = torch.where(stopped, neg, nxt)
        out[n - k] = cur
    return out


def _step_tables(nrow, latlon, transform):
    """(2 nrow,) step lengths in metres indexed by the sum of the two rows:
    on a latlon grid the lengths of a degree at the mean latitude of the two
    rows; on a projected grid the resolutions, x and y swapped as in
    ``geodesy.distance``."""
    xres, yres, north = transform[0], transform[4], transform[5]
    if latlon:
        lat = north + np.arange(2 * nrow) / 2.0 * yres
        stepy = geodesy.degree_metres_y(lat) * yres
        stepx = geodesy.degree_metres_x(lat) * xres
    else:
        stepy = np.full(2 * nrow, xres, dtype=np.float64)
        stepx = np.full(2 * nrow, yres, dtype=np.float64)
    return np.ascontiguousarray(stepx), np.ascontiguousarray(stepy)


def _trace_batch(idxs0, idxs_nxt, ncol, mask, max_length, real_length, latlon, transform):
    """CSR walks of a batch of seeds (``runtime.trace_walks``): each stops at
    a pit or a missing next cell, at a True ``mask`` cell (the seed
    included), or before the step that takes its distance past
    ``max_length``; distances in metres where ``real_length`` and ``ncol``,
    else in steps."""
    from ..runtime import trace_walks

    idxs_nxt = np.asarray(idxs_nxt)
    if real_length and ncol is not None:
        nrow = -(-idxs_nxt.size // ncol)
        stepx, stepy = _step_tables(nrow, latlon, transform)
    else:
        stepx = stepy = None
    return trace_walks(
        idxs_nxt,
        np.atleast_1d(np.asarray(idxs0)),
        mask=None if mask is None else np.asarray(mask),
        stepx=stepx,
        stepy=stepy,
        ncol=0 if ncol is None else int(ncol),
        max_length=-1.0 if max_length is None else float(max_length),
    )


def trace(idx0, idxs_nxt, ncol=None, mask=None, max_length=None, real_length=False,
          latlon=False, transform=IDENTITY):
    """One walk along ``idxs_nxt`` from ``idx0``: (int64 cells, distance)."""
    off, data, dists = _trace_batch(
        [idx0], idxs_nxt, ncol, mask, max_length, real_length, latlon, transform
    )
    return data, float(dists[0])


def paths(idxs0, idxs_nxt, ncol=None, mask=None, max_length=None, real_length=False,
          latlon=False, transform=IDENTITY):
    """Walks from several seeds: (list of int64 cell arrays, float64
    distances)."""
    off, data, dists = _trace_batch(
        idxs0, idxs_nxt, ncol, mask, max_length, real_length, latlon, transform
    )
    return [data[off[i]:off[i + 1]] for i in range(off.size - 1)], dists


def snap_walk(idxs0, idxs_nxt, ncol=None, mask=None, max_length=None, real_length=False,
              latlon=False, transform=IDENTITY):
    """The last cell and the distance of the walk from each seed: (int64
    cells, float32 distances)."""
    off, data, dists = _trace_batch(
        idxs0, idxs_nxt, ncol, mask, max_length, real_length, latlon, transform
    )
    return data[off[1:] - 1], dists.astype(np.float32)
