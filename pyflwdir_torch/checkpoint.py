"""Directory checkpoints of a raster's graph, in tiles.

``<dir>/manifest.json`` plus each raster as 2-D ``.npy`` tiles under
``<dir>/<name>/r<ri>_c<ci>.npy``: ``idxs_ds`` and any companion rasters of
the grid's shape. Writes and reads go tile by tile, and a reader may load
only a window of tiles (``tile_slice``). It is the JAX package's format, so
each package loads the other's checkpoints.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["save_sharded", "load_sharded", "save_raster", "load_raster"]

_FMT = 1


def _tile_grid(shape, tile):
    return -(-shape[0] // tile[0]), -(-shape[1] // tile[1])


def save_raster(path, name, data2d, tile=(4096, 4096)):
    """Write one 2-D array as ``.npy`` tiles under ``path/name/``; returns
    its manifest entry."""
    data2d = np.asarray(data2d)
    nr, nc = _tile_grid(data2d.shape, tile)
    d = os.path.join(path, name)
    os.makedirs(d, exist_ok=True)
    for ri in range(nr):
        for ci in range(nc):
            t = data2d[ri * tile[0]:(ri + 1) * tile[0], ci * tile[1]:(ci + 1) * tile[1]]
            np.save(os.path.join(d, f"r{ri}_c{ci}.npy"), t)
    return {"shape": list(data2d.shape), "tile": list(tile), "dtype": data2d.dtype.str}


def load_raster(path, name, meta, tile_slice=None):
    """Read a tiled raster back; ``tile_slice=(r0, r1, c0, c1)`` reads only
    that window of tile indices."""
    nr, nc = _tile_grid(tuple(meta["shape"]), tuple(meta["tile"]))
    r0, r1, c0, c1 = tile_slice if tile_slice is not None else (0, nr, 0, nc)
    rows = []
    for ri in range(r0, r1):
        cols = [np.load(os.path.join(path, name, f"r{ri}_c{ci}.npy")) for ci in range(c0, c1)]
        rows.append(np.concatenate(cols, axis=1))
    return np.concatenate(rows, axis=0)


def save_sharded(flw, path, tile=(4096, 4096), rasters=None):
    """Checkpoint the FlwdirRaster ``flw`` and the companion ``rasters`` (a
    dict of 2-D arrays of ``flw.shape``) into the directory ``path``;
    returns the manifest."""
    os.makedirs(path, exist_ok=True)
    manifest = {
        "format": _FMT,
        "ftype": flw.ftype,
        "shape": list(flw.shape),
        "nnodes": int(flw.nnodes),
        "transform": list(flw.transform)[:6],
        "latlon": bool(flw.latlon),
        "rasters": {},
    }
    ids = np.asarray(flw.idxs_ds).reshape(flw.shape)
    manifest["rasters"]["idxs_ds"] = save_raster(path, "idxs_ds", ids, tile)
    for name, arr in (rasters or {}).items():
        manifest["rasters"][name] = save_raster(path, name, arr, tile)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_sharded(path, rasters=(), device=None):
    """Load a checkpoint directory: ``(FlwdirRaster on device, {name:
    array})`` for the companion ``rasters`` named. ``device`` None means
    the card."""
    from .raster import FlwdirRaster
    from .utils.affine import Affine

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    ids = load_raster(path, "idxs_ds", manifest["rasters"]["idxs_ds"])
    flw = FlwdirRaster(
        idxs_ds=ids.ravel(),
        shape=tuple(manifest["shape"]),
        ftype=manifest["ftype"],
        transform=Affine(*manifest["transform"]),
        latlon=manifest["latlon"],
        device=device,
    )
    extra = {name: load_raster(path, name, manifest["rasters"][name]) for name in rasters}
    return flw, extra
