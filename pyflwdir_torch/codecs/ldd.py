"""LDD (PCRaster keypad) flow-direction codec.

Vectorized equivalent of the reference codec
upstream pyflwdir ``core_ldd.py``: keypad encoding with pit = 5 and
nodata = 255, decoded via 256-entry LUTs like the D8 codec.

Encoding (core_ldd.py:13-17)::

    _ds = [[7, 8, 9],
           [4, 5, 6],
           [1, 2, 3]]   # value at (dr+1, dc+1), pit = 5, nodata = 255
"""

from __future__ import annotations

import numpy as np

_ftype = "ldd"
_ds = np.array([[7, 8, 9], [4, 5, 6], [1, 2, 3]], dtype=np.uint8)
_us = np.array([[3, 2, 1], [6, 5, 4], [9, 8, 7]], dtype=np.uint8)
_mv = np.uint8(255)
_pv = np.uint8(5)
_all = np.array([7, 8, 9, 4, 5, 6, 1, 2, 3, 255], dtype=np.uint8)

_DR_LUT = np.zeros(256, dtype=np.int8)
_DC_LUT = np.zeros(256, dtype=np.int8)
for _dr in range(3):
    for _dc in range(3):
        _DR_LUT[_ds[_dr, _dc]] = _dr - 1
        _DC_LUT[_ds[_dr, _dc]] = _dc - 1
_DR_LUT[_pv] = _DC_LUT[_pv] = 0  # pit
_VALID_LUT = np.zeros(256, dtype=bool)
_VALID_LUT[_all] = True

_ENC_LUT = _ds.ravel().copy()


def drdc(dd):
    """Vectorized ldd value(s) -> (delta row, delta col). Parity: core_ldd.py:24."""
    dd = np.asarray(dd, dtype=np.uint8)
    return _DR_LUT[dd], _DC_LUT[dd]


def from_array(flwdir, _mv=_mv, dtype=np.int32):
    """2-D LDD raster -> (idxs_ds, idxs_pit, n). Parity: core_ldd.py:42-66."""
    flwdir = np.asarray(flwdir)
    nrow, ncol = flwdir.shape
    if flwdir.dtype == np.uint8 and flwdir.size < 2**31 - 1:
        # native threaded parse (csrc/tile_plan_build.cpp), int32 indices
        from ..runtime import flw_from_array_lut

        idxs_ds, idxs_pit, nv = flw_from_array_lut(flwdir, _DR_LUT, _DC_LUT, _mv)
        return idxs_ds.astype(dtype), idxs_pit.astype(dtype), nv
    flat = flwdir.ravel()
    valid = flat != _mv
    dr = _DR_LUT[flat].astype(np.int64)
    dc = _DC_LUT[flat].astype(np.int64)
    idxs = np.arange(flat.size, dtype=np.int64)
    r_ds = idxs // ncol + dr
    c_ds = idxs % ncol + dc
    pit = (dr == 0) & (dc == 0)
    outside = (r_ds < 0) | (r_ds >= nrow) | (c_ds < 0) | (c_ds >= ncol)
    idx_ds = np.where(outside, 0, r_ds * ncol + c_ds)
    ds_nodata = flat[idx_ds] == _mv
    to_pit = valid & (pit | outside | ds_nodata)
    idxs_ds = np.where(valid, np.where(to_pit, idxs, idx_ds), -1).astype(dtype)
    idxs_pit = np.where(to_pit)[0].astype(dtype)
    return idxs_ds, idxs_pit, int(valid.sum())


def to_array(idxs_ds, shape, mv=-1):
    """Next-downstream indices -> dense 2-D LDD raster. Parity: core_ldd.py:86-101."""
    idxs_ds = np.asarray(idxs_ds)
    ncol = shape[1]
    idxs = np.arange(idxs_ds.size, dtype=np.int64)
    valid = idxs_ds != mv
    ds = np.where(valid, idxs_ds, idxs).astype(np.int64)
    dr = ds // ncol - idxs // ncol
    dc = ds % ncol - idxs % ncol
    if np.any(valid & ((np.abs(dr) > 1) | (np.abs(dc) > 1))):
        raise ValueError("Invalid data downstream index outside 8 neighbors.")
    code = _ENC_LUT[((dr + 1) * 3 + (dc + 1)).clip(0, 8)]
    return np.where(valid, code, _mv).astype(np.uint8).reshape(shape)


def isvalid(flwdir, _all=_all):
    """True if 2-D LDD raster is valid. Parity: core_ldd.py:104-106."""
    return (
        isinstance(flwdir, np.ndarray)
        and flwdir.dtype == "uint8"
        and flwdir.ndim == 2
        and bool(np.all(_VALID_LUT[flwdir.ravel()]))
    )


def ispit(dd, _pv=_pv):
    """True for LDD pit value(s). Parity: core_ldd.py:110."""
    return np.asarray(dd) == _pv


def isnodata(dd, _mv=_mv):
    """True for LDD nodata value(s). Parity: core_ldd.py:116."""
    return np.asarray(dd) == _mv
