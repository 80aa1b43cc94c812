"""D8 flow-direction codec (ESRI-style powers of two).

Vectorized (table-lookup) equivalent of the reference codec
upstream pyflwdir ``core_d8.py``: the scalar ``drdc`` bit-math decode
(core_d8.py:22-39) becomes a 256-entry LUT gather, and
``from_array``/``to_array`` (core_d8.py:43-102) become whole-grid
elementwise ops — no per-cell Python/numba loop.

Encoding (core_d8.py:15-19)::

    _ds = [[32,  64, 128],
           [16,   0,   1],
           [ 8,   4,   2]]      # value at (dr+1, dc+1), pit = 0 or 255
    nodata = 247
"""

from __future__ import annotations

import numpy as np

_ftype = "d8"
_ds = np.array([[32, 64, 128], [16, 0, 1], [8, 4, 2]], dtype=np.uint8)
_us = np.array([[2, 4, 8], [1, 0, 16], [128, 64, 32]], dtype=np.uint8)
_mv = np.uint8(247)
_pv = np.array([0, 255], dtype=np.uint8)
_all = np.array([32, 64, 128, 16, 0, 1, 8, 4, 2, 247, 255], dtype=np.uint8)

# -- decode LUTs: d8 code -> (dr, dc); invalid codes decode to (0, 0) -------
_DR_LUT = np.zeros(256, dtype=np.int8)
_DC_LUT = np.zeros(256, dtype=np.int8)
for _dr in range(3):
    for _dc in range(3):
        _DR_LUT[_ds[_dr, _dc]] = _dr - 1
        _DC_LUT[_ds[_dr, _dc]] = _dc - 1
_DR_LUT[0] = _DC_LUT[0] = 0  # pit
_VALID_LUT = np.zeros(256, dtype=bool)
_VALID_LUT[_all] = True


def drdc(dd):
    """Vectorized d8 value(s) -> (delta row, delta col). Parity: core_d8.py:22."""
    dd = np.asarray(dd, dtype=np.uint8)
    return _DR_LUT[dd], _DC_LUT[dd]


def from_array(flwdir, _mv=_mv, dtype=np.int32):
    """Convert a 2-D D8 raster to 1-D next-downstream indices.

    Returns ``(idxs_ds, idxs_pit, n)`` where ``idxs_ds[i] == i`` marks a pit,
    ``idxs_ds[i] == -1`` marks missing, and ``n`` is the number of valid
    cells. Cells whose downstream neighbor is outside the domain or nodata
    become pits. Parity: reference core_d8.py:43-67 (with mv = -1 instead of
    the reference's dtype-dependent sentinel).
    """
    flwdir = np.asarray(flwdir)
    nrow, ncol = flwdir.shape
    n = flwdir.size
    if flwdir.dtype == np.uint8 and n < 2**31 - 1:
        # native threaded parse (csrc/tile_plan_build.cpp), int32 indices
        from ..runtime import flw_from_array_lut

        idxs_ds, idxs_pit, nv = flw_from_array_lut(flwdir, _DR_LUT, _DC_LUT, _mv)
        return idxs_ds.astype(dtype), idxs_pit.astype(dtype), nv
    # 2-D int32 broadcast arithmetic: no int64 div/mod passes over the
    # grid (the row/col of a cell are its array coordinates). Widen when
    # even an out-of-grid lane (r_ds == nrow) could overflow before the
    # np.where masks it: n + ncol must stay below int32 max.
    it = np.int64 if n + ncol > np.iinfo(np.int32).max else np.int32
    valid = flwdir != _mv
    dr = _DR_LUT[flwdir]
    dc = _DC_LUT[flwdir]
    pit = (dr == 0) & (dc == 0)
    r_ds = np.arange(nrow, dtype=np.int32)[:, None] + dr
    c_ds = np.arange(ncol, dtype=np.int32)[None, :] + dc
    outside = (r_ds < 0) | (r_ds >= nrow) | (c_ds < 0) | (c_ds >= ncol)
    idx_ds = np.where(outside, 0, r_ds.astype(it) * ncol + c_ds)
    ds_nodata = flwdir.ravel()[idx_ds.ravel()].reshape(nrow, ncol) == _mv
    to_pit = valid & (pit | outside | ds_nodata)
    iself = np.arange(nrow, dtype=it)[:, None] * ncol + np.arange(ncol, dtype=it)
    idxs_ds = np.where(valid, np.where(to_pit, iself, idx_ds), -1)
    idxs_ds = idxs_ds.astype(dtype).ravel()
    idxs_pit = np.flatnonzero(to_pit).astype(dtype)
    return idxs_ds, idxs_pit, int(valid.sum())


# -- encode LUT: (dr+1)*3 + (dc+1) -> d8 code -------------------------------
_ENC_LUT = _ds.ravel().copy()


def to_array(idxs_ds, shape, mv=-1):
    """Convert next-downstream indices back to a dense 2-D D8 raster.

    Parity: reference core_d8.py:87-102.
    """
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
    """True if 2-D D8 raster is valid. Parity: core_d8.py:105-122."""
    return (
        isinstance(flwdir, np.ndarray)
        and flwdir.dtype == "uint8"
        and flwdir.ndim == 2
        and bool(np.all(_VALID_LUT[flwdir.ravel()]))
    )


def ispit(dd, _pv=_pv):
    """True for D8 pit value(s). Parity: core_d8.py:126."""
    return np.isin(np.asarray(dd), _pv)


def isnodata(dd, _mv=_mv):
    """True for D8 nodata value(s). Parity: core_d8.py:132."""
    return np.asarray(dd) == _mv
