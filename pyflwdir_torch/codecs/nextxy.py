"""NEXTXY (CaMa-Flood) flow-direction codec.

Vectorized equivalent of the reference codec
upstream pyflwdir ``core_nextxy.py``: two (nrow, ncol) int32 rasters
holding the one-based (col, row) of the downstream cell; pits are -9 (ocean
outlet) / -10 (inland), nodata is -9999.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.affine import transform_from_bounds

_ftype = "nextxy"
_mv = np.int32(-9999)
# -10 inland termination, -9 river outlet at ocean (core_nextxy.py:17-18)
_pv = np.array([-9, -10], dtype=np.int32)
# for consistency with LDD/D8 types and testing (core_nextxy.py:19-21)
_us = np.ones((2, 3, 3), dtype=np.int32) * 2
_us[:, 1, 1] = _pv[0]

__all__ = ["read_nextxy"]


def _unpack(flwdir):
    if isinstance(flwdir, tuple) and len(flwdir) == 2:
        return flwdir
    flwdir = np.asarray(flwdir)
    if flwdir.ndim == 3 and flwdir.shape[0] == 2:
        return flwdir[0], flwdir[1]
    raise TypeError("NEXTXY flwdir data not understood")


def from_array(flwdir, dtype=np.int32):
    """(nextx, nexty) -> (idxs_ds, idxs_pit, n). Parity: core_nextxy.py:24-68."""
    nextx, nexty = _unpack(flwdir)
    nrow, ncol = nextx.shape[0], nextx.shape[-1]
    fx = np.asarray(nextx).ravel()
    fy = np.asarray(nexty).ravel()
    valid = fx != _mv
    pit = ispit(fx) | ispit(fy)
    r_ds = fy.astype(np.int64) - 1
    c_ds = fx.astype(np.int64) - 1
    outside = (r_ds < 0) | (r_ds >= nrow) | (c_ds < 0) | (c_ds >= ncol)
    idx_ds = np.where(outside, 0, r_ds * ncol + c_ds)
    ds_nodata = fx[idx_ds] == _mv
    idxs = np.arange(fx.size, dtype=np.int64)
    to_pit = valid & (pit | outside | ds_nodata)
    idxs_ds = np.where(valid, np.where(to_pit, idxs, idx_ds), -1).astype(dtype)
    idxs_pit = np.where(to_pit)[0].astype(dtype)
    return idxs_ds, idxs_pit, int(valid.sum())


def to_array(idxs_ds, shape, mv=-1):
    """Next-downstream indices -> stacked (2, nrow, ncol) NEXTXY raster.

    Parity: core_nextxy.py:36-88 (pits encoded with ``_pv[0]`` = -9).
    """
    idxs_ds = np.asarray(idxs_ds)
    ncol = shape[1]
    idxs = np.arange(idxs_ds.size, dtype=np.int64)
    valid = idxs_ds != mv
    pit = valid & (idxs_ds == idxs)
    ds = np.where(valid, idxs_ds, idxs).astype(np.int64)
    nextx = np.where(valid, np.where(pit, _pv[0], ds % ncol + 1), _mv)
    nexty = np.where(valid, np.where(pit, _pv[0], ds // ncol + 1), _mv)
    return np.stack(
        [nextx.astype(np.int32).reshape(shape), nexty.astype(np.int32).reshape(shape)]
    )


def isvalid(flwdir):
    """True if NEXTXY raster is valid. Parity: core_nextxy.py:91-107."""
    try:
        nextx, nexty = _unpack(flwdir)
    except TypeError:
        return False
    mask = np.logical_or(isnodata(nextx), ispit(nextx))
    return (
        nexty.dtype == "int32"
        and nextx.dtype == "int32"
        and np.all(nexty.shape == nextx.shape)
        and bool(np.all(nextx[~mask] >= 0))
        and bool(np.all(nextx[mask] == nexty[mask]))
    )


def ispit(dd, _pv=_pv):
    """True for NEXTXY pit value(s). Parity: core_nextxy.py:111."""
    dd = np.asarray(dd)
    return np.logical_or(dd == _pv[0], dd == _pv[1])


def isnodata(dd):
    """True for NEXTXY nodata value(s). Parity: core_nextxy.py:117."""
    return np.asarray(dd) == _mv


def read_nextxy(fn, nrow, ncol, bbox):
    """Read NEXTXY data from a CaMa-Flood binary file.

    Parity: reference core_nextxy.py:122-144. Returns the (2, nrow, ncol)
    data and the affine transform derived from the bounding box.
    """
    data = np.fromfile(str(Path(fn)), "i4").reshape(2, nrow, ncol)
    assert len(bbox) == 4, "Bounding box should contain 4 coordinates."
    transform = transform_from_bounds(*bbox, ncol, nrow)
    return data, transform
