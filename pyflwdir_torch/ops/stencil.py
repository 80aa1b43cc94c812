"""Raster-local (stencil) operators: D8 / LDD decoding and tile-local pointers.

For a raster the flow graph is a 3x3 stencil: every cell's downstream cell
is one of its 8 neighbours. These functions decode D8 or LDD code rasters
to steps and pointers on the tensor's device, by gathers from the codecs'
lookup tables (the device counterpart of :func:`pyflwdir_torch.codecs.d8.
from_array`), and give the multi-device runtime
(:mod:`pyflwdir_torch.parallel.tiled`) the graph of one tile.

Each function takes a 2-D tensor of codes (an array goes to the card) and
returns tensors on its device: steps ``dr``, ``dc`` int32, masks bool and
flat indices int64.
"""

from __future__ import annotations

import numpy as np
import torch

from .._backend import resolve_device
from ..codecs import d8 as d8c
from ..codecs import ldd as lddc

__all__ = ["decode_d8", "decode_ldd", "idxs_ds_from_d8", "local_pointers"]


def _codes(codes):
    """``codes`` as a tensor: a tensor stays on its device, an array goes to
    the card."""
    if isinstance(codes, torch.Tensor):
        return codes
    return torch.as_tensor(np.asarray(codes), device=resolve_device(None))


def _decode(codes, codec):
    codes = _codes(codes).to(torch.uint8)
    idx = codes.long()
    dev = codes.device
    dr = torch.as_tensor(codec._DR_LUT.astype(np.int32), device=dev)[idx]
    dc = torch.as_tensor(codec._DC_LUT.astype(np.int32), device=dev)[idx]
    return dr, dc, codes != int(codec._mv)


def decode_d8(codes):
    """``(dr, dc, valid)`` of a 2-D D8 code raster."""
    return _decode(codes, d8c)


def decode_ldd(codes):
    """``(dr, dc, valid)`` of a 2-D LDD code raster."""
    return _decode(codes, lddc)


def _grid(th, tw, dev):
    r = torch.arange(th, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(tw, dtype=torch.int64, device=dev)[None, :]
    return r, c


def idxs_ds_from_d8(codes):
    """Flat next-downstream indices (int64) of a 2-D D8 code raster, the
    values of ``codecs.d8.from_array``: cells whose step leaves the grid or
    lands on a nodata cell are pits, missing cells -1."""
    dr, dc, valid = decode_d8(codes)
    nrow, ncol = valid.shape
    r, c = _grid(nrow, ncol, valid.device)
    r_ds, c_ds = r + dr, c + dc
    pit = (dr == 0) & (dc == 0)
    outside = (r_ds < 0) | (r_ds >= nrow) | (c_ds < 0) | (c_ds >= ncol)
    r_cl, c_cl = r_ds.clamp(0, nrow - 1), c_ds.clamp(0, ncol - 1)
    to_pit = pit | outside | ~valid[r_cl, c_cl]
    out = torch.where(to_pit, r * ncol + c, r_cl * ncol + c_cl)
    return torch.where(valid, out, torch.full_like(out, -1)).reshape(-1)


def local_pointers(codes):
    """The graph of one (th, tw) tile of D8 codes: ``(local_ds, exit_dr,
    exit_dc, valid)``. ``local_ds`` (flat, int64) is the in-tile
    downstream index; cells whose step leaves the tile, pits and cells
    draining into a nodata cell of the tile point at themselves (local
    roots). ``exit_dr`` / ``exit_dc`` (th, tw) are the step out of the tile
    of valid cells that take one, 0 elsewhere."""
    dr, dc, valid = decode_d8(codes)
    th, tw = valid.shape
    r, c = _grid(th, tw, valid.device)
    r_ds, c_ds = r + dr, c + dc
    inside = (r_ds >= 0) & (r_ds < th) & (c_ds >= 0) & (c_ds < tw)
    r_cl, c_cl = r_ds.clamp(0, th - 1), c_ds.clamp(0, tw - 1)
    local_ds = torch.where(valid & inside & valid[r_cl, c_cl], r_cl * tw + c_cl, r * tw + c)
    is_exit = valid & ~inside & ~((dr == 0) & (dc == 0))
    zero = torch.zeros_like(dr)
    return (local_ds.reshape(-1), torch.where(is_exit, dr, zero),
            torch.where(is_exit, dc, zero), valid)
