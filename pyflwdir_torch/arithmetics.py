"""Moving-window statistics, upstream sums and least squares over the flow
network, in plain PyTorch on the tensors' device.

A window is one ``(2n+1, size)`` gather (:func:`ops.walk.window_indices`),
reduced along its first axis. The median is the midpoint of the two middle
valid values, as ``jnp.nanmedian`` takes it: ``torch.nanmedian`` returns
the lower of the two, so the port sorts the window (NaN last) and takes
``(s[(k-1)//2] + s[k//2]) * 0.5`` of the ``k`` valid values. Float upstream
sums add in an order fixed by the data (``graph._sum_by_target``), so two
calls on the card give the same bits.
"""

from __future__ import annotations

import math

import torch

from ._backend import resolve_device
from .ops import graph
from .ops.walk import window_indices

__all__ = ["moving_average", "moving_median", "upstream_sum", "lstsq"]


def _is_nodata(vals, nodata):
    if isinstance(nodata, float) and math.isnan(nodata):
        return torch.isnan(vals)
    return vals == nodata


def moving_average(data, weights, n, idxs_ds, idxs_us_main, strord=None, nodata=-9999.0):
    """Weighted average over the window of the ``n`` nearest cells up- and
    downstream (``strord``: the downstream walk stops before a higher
    order). Nodata window entries are left out; nodata cells, and cells with
    no weight in their window, are ``nodata``. The window's rows are summed
    in order, in the types the JAX package's expression takes: the weights
    in float64 where None, else in their own type; the weighted values in
    ``data``'s float type where there are no weights (float64 for integer
    data), else in the promoted type of weights and data. The result is in
    ``data``'s dtype."""
    win = window_indices(idxs_ds, idxs_us_main, n, strord=strord)
    f64 = torch.float64
    if weights is None:
        w_dt, num_dt = f64, (data.dtype if data.dtype.is_floating_point else f64)
    else:
        w_dt = weights.dtype
        num_dt = torch.promote_types(w_dt, data.dtype)
    dev = data.device
    wsum = torch.zeros(win.shape[1], dtype=w_dt, device=dev)
    num = torch.zeros(win.shape[1], dtype=num_dt, device=dev)
    for row in win:  # the window's rows in order, one row of terms at a time
        at = row.clamp(min=0)
        vals = data[at]
        ok = (row >= 0) & ~_is_nodata(vals, nodata)
        w = ok.to(w_dt) if weights is None else torch.where(ok, weights[at], 0)
        wsum += w
        num += w.to(num_dt) * torch.where(ok, vals, 0).to(num_dt)
    has = wsum != 0
    avg = num.to(torch.promote_types(num_dt, w_dt)) / torch.where(has, wsum, 1)
    avg = torch.where(has, avg, torch.full_like(avg, nodata))
    avg = torch.where(_is_nodata(data, nodata), torch.full_like(avg, nodata), avg)
    return avg.to(data.dtype)


def moving_median(data, n, idxs_ds, idxs_us_main, strord=None, nodata=-9999.0):
    """Median over the window of :func:`moving_average`, the midpoint of the
    two middle valid values where their count is even (``jnp.nanmedian``'s
    rule), in float64 for float64 data and float32 otherwise; nodata cells
    stay ``nodata``. Returns ``data``'s dtype."""
    win = window_indices(idxs_ds, idxs_us_main, n, strord=strord)
    vals = data[win.clamp(min=0)]
    ok = (win >= 0) & ~_is_nodata(vals, nodata)
    del win
    dt = torch.float64 if data.dtype == torch.float64 else torch.float32
    vals = torch.where(ok, vals.to(dt), torch.full((), math.nan, dtype=dt, device=data.device))
    k = ok.sum(dim=0, keepdim=True)
    del ok
    s = torch.sort(vals, dim=0).values  # NaN sorts last
    del vals
    lo = torch.gather(s, 0, ((k - 1).clamp(min=0)) // 2)
    hi = torch.gather(s, 0, torch.minimum(k // 2, (k - 1).clamp(min=0)))
    med = ((lo + hi) * 0.5)[0]
    med = torch.where(_is_nodata(data, nodata), torch.full_like(med, nodata), med)
    return med.to(data.dtype)


def upstream_sum(idxs_ds, data, nodata=-9999.0):
    """Sum of the values of each cell's direct upstream cells. A cell whose
    own value or downstream value is ``nodata`` is ``nodata`` (pits and
    missing cells keep their sum); a nodata upstream value adds nothing.
    Integers sum exactly by scatter, floats in a fixed order."""
    n = idxs_ds.shape[0]
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=idxs_ds.device)
    moving = (idxs_ds >= 0) & (idxs_ds != ar)
    own_bad = data == nodata
    ds_bad = own_bad[graph.self_loop(idxs_ds)]
    send = moving & ~own_bad & ~ds_bad
    tgt = torch.where(send, idxs_ds, torch.full_like(idxs_ds, n))
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    out = graph._scatter(tgt, torch.where(send, data, zero), n, "add")
    bad = moving & (own_bad | ds_bad)
    return torch.where(bad, torch.full((), nodata, dtype=data.dtype, device=data.device), out)


def lstsq(x, y, device=None):
    """Ordinary least squares slope and intercept along the last axis, in
    float64 (closed form), on ``x``'s device where it is a tensor, else on
    ``device`` (None: the card)."""
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float64, device=dev)
    y = torch.as_tensor(y, dtype=torch.float64, device=dev)
    n = x.shape[-1]
    x_sum = x.sum(dim=-1)
    y_sum = y.sum(dim=-1)
    x_sq_sum = (x * x).sum(dim=-1)
    x_y_sum = (x * y).sum(dim=-1)
    slope = (n * x_y_sum - x_sum * y_sum) / (n * x_sq_sum - x_sum**2)
    intercept = (y_sum - slope * x_sum) / n
    return slope, intercept
