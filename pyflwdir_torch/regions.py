"""Measurements of labelled regions.

The label extents behind :func:`region_slices` and :func:`region_bounds`
(four ``scatter_reduce`` passes, ``amin`` / ``amax`` of the rows and
columns of the labelled cells) and :func:`region_outlets` run on the
device, integers all, so they are exact. :func:`region_sum` and
:func:`region_area` run on the host with ``scipy.ndimage``;
:func:`region_dissolve` spreads the kept regions with the native
:func:`gridtools.spread2d`.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from ._backend import resolve_device
from .utils import geodesy
from .utils.affine import IDENTITY

__all__ = [
    "region_bounds",
    "region_slices",
    "region_sum",
    "region_area",
    "region_outlets",
    "region_dissolve",
]


def region_sum(data, regions):
    """Sum of ``data`` over each positive label: (sorted labels, sums)."""
    lbs = np.unique(regions[regions > 0])
    return lbs, ndimage.sum(data, regions, index=lbs)


def region_area(regions, transform=IDENTITY, latlon=False):
    """Area in m2 of each positive label: (sorted labels, areas)."""
    area = geodesy.area_grid(transform=transform, shape=regions.shape, latlon=latlon)
    return region_sum(area, regions)


def _labels_dev(regions, device):
    """``regions`` flattened on ``device``; the unsigned types past 8 bits,
    which torch does not reduce, as int64."""
    reg = np.asarray(regions).ravel()
    if reg.dtype.kind == "u" and reg.dtype.itemsize > 1:
        reg = reg.astype(np.int64)
    return torch.as_tensor(reg, device=device)


def _label_extents(regions, device=None):
    """The sorted positive labels and, for each, the least and greatest row
    and column of its cells: ``(lbs, rmin, rmax, cmin, cmax)``, int64 numpy
    arrays, reduced on ``device`` (None: the card)."""
    if np.ndim(regions) != 2:
        raise ValueError('The "regions" array should be two dimensional')
    nrow, ncol = np.shape(regions)
    flat = _labels_dev(regions, resolve_device(device))
    cells = torch.nonzero(flat > 0).ravel()
    if cells.numel() == 0:
        raise ValueError("No regions found in data")
    lbs, inv = torch.unique(flat[cells], sorted=True, return_inverse=True)
    rows, cols = cells // ncol, cells % ncol
    k = lbs.numel()

    def red(vals, init, how):
        out = torch.full((k,), init, dtype=torch.int64, device=cells.device)
        return out.scatter_reduce_(0, inv, vals, reduce=how, include_self=True).cpu().numpy()

    lbs = lbs.cpu().numpy().astype(np.asarray(regions).dtype)
    return (lbs, red(rows, nrow, "amin"), red(rows, -1, "amax"), red(cols, ncol, "amin"),
            red(cols, -1, "amax"))


def region_slices(regions, device=None):
    """The bounding (row, column) slices of each positive label: (sorted
    labels, list of slice pairs)."""
    lbs, rmin, rmax, cmin, cmax = _label_extents(regions, device)
    slices = [
        (slice(int(r0), int(r1) + 1), slice(int(c0), int(c1) + 1))
        for r0, r1, c0, c1 in zip(rmin, rmax, cmin, cmax)
    ]
    return lbs, slices


def region_bounds(regions, transform=IDENTITY, device=None):
    """The cell-edge bounding box ``[xmin, ymin, xmax, ymax]`` of each
    positive label: (sorted labels, (k, 4) boxes, the box of them all)."""
    lbs, rmin, rmax, cmin, cmax = _label_extents(regions, device)
    xres, yres = transform[0], transform[4]
    xoff, yoff = transform[2], transform[5]
    xa, xb = xoff + cmin * xres, xoff + (cmax + 1) * xres
    ya, yb = yoff + rmin * yres, yoff + (rmax + 1) * yres
    bboxs = np.stack(
        [np.minimum(xa, xb), np.minimum(ya, yb), np.maximum(xa, xb), np.maximum(ya, yb)],
        axis=1,
    )
    total_bbox = np.hstack([bboxs[:, :2].min(axis=0), bboxs[:, 2:].max(axis=0)])
    return lbs, bboxs, total_bbox


def region_outlets(regions, idxs_ds, device=None):
    """The outlet cells of each positive label: the region's valid cells
    whose downstream cell is a pit or lies outside the region. Runs on
    ``idxs_ds``' device where it is a tensor, else on ``device`` (None: the
    card). Returns (labels, int64 cells), a stable sort on the label."""
    if not isinstance(idxs_ds, torch.Tensor):
        idxs_ds = torch.as_tensor(np.asarray(idxs_ds, dtype=np.int64),
                                  device=resolve_device(device))
    lb = _labels_dev(regions, idxs_ds.device)
    ar = torch.arange(idxs_ds.shape[0], dtype=idxs_ds.dtype, device=idxs_ds.device)
    ds = torch.where(idxs_ds < 0, ar, idxs_ds)
    is_out = (idxs_ds >= 0) & (lb > 0) & ((ds == ar) | (lb[ds] != lb))
    idxs_out = torch.nonzero(is_out).ravel()
    lbs, perm = torch.sort(lb[idxs_out], stable=True)
    return lbs.cpu().numpy().astype(np.asarray(regions).dtype), idxs_out[perm].cpu().numpy()


def region_dissolve(regions, labels=None, idxs=None, transform=IDENTITY, latlon=False,
                    **kwargs):
    """Dissolve the regions named by ``labels`` (or by the cells ``idxs``)
    into their nearest neighbouring regions, by the native
    :func:`gridtools.spread2d` of the other regions; ``kwargs`` go to it."""
    from .gridtools import spread2d

    regions = np.asarray(regions)
    if regions.ndim != 2:
        raise ValueError('The "regions" array should be two dimensional')
    if (labels is None) == (idxs is None):
        raise ValueError('Either "labels" or "idxs" must be provided.')
    if labels is None:
        labels = regions.flat[np.atleast_1d(idxs)]
    else:
        labels = np.atleast_1d(labels)
    if np.unique(labels[labels > 0]).size != labels.size:
        raise ValueError("Found non-unique or zero-value labels.")

    keep = np.where(np.isin(regions, labels), 0, regions)
    if not np.any(keep != 0):
        raise ValueError("No regions left to dissolve into")
    out, _, dst = spread2d(keep, nodata=0, transform=transform, latlon=latlon, **kwargs)

    if idxs is None:
        # each dissolved label's cell nearest the kept regions (the first in
        # row-major order among equals), by one grouped sort
        sel = np.isin(regions.ravel(), labels)
        cells = np.nonzero(sel)[0]
        order = np.lexsort((cells, dst.ravel()[cells], regions.ravel()[cells]))
        li = regions.ravel()[cells][order]
        idxs = cells[order][np.searchsorted(li, labels)]
    idxs = np.atleast_1d(idxs)

    new_of = out.flat[idxs]
    order = np.argsort(labels)
    src, dst_lb = np.asarray(labels)[order], np.asarray(new_of)[order]
    flat = regions.ravel()
    p = np.clip(np.searchsorted(src, flat), 0, src.size - 1)
    hit = src[p] == flat
    return np.where(hit, dst_lb[p], flat).reshape(regions.shape)
