"""DEM conditioning: edge cells, the exact host priority-flood depression
fill that turns a DEM into D8 codes, the slope, the height above the
nearest drain, floodplains, and the streamline repairs (elevation
adjustment, D4 digging).

The slope (a 3x3 stencil), HAND and the floodplains (``reach`` and a path
maximum) run on the device; the fill, the edge cells and the streamline
repairs on the host (numpy and the native library). The device fill, the
fill's counterpart on the card, is :mod:`pyflwdir_torch.ops.fill`.
"""

from __future__ import annotations

import numpy as np
import torch

from ._backend import resolve_device
from .utils import geodesy
from .utils.affine import IDENTITY

__all__ = [
    "fill_depressions",
    "adjust_elevation",
    "slope",
    "height_above_nearest_drain",
    "floodplains",
    "dig_4connectivity",
    "get_edge",
]


def get_edge(a, structure=None):
    """Edge cells of the valid mask: a valid cell on the array border, or
    with any structuring-element neighbor invalid (upstream pyflwdir
    ``gis_utils.get_edge``)."""
    a = np.asarray(a, dtype=bool)
    if structure is None:
        structure = np.ones((3, 3), dtype=bool)
    nrow, ncol = a.shape
    pad = np.pad(a, 1, mode="constant", constant_values=False)
    all_nb = np.ones_like(a)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if structure[dr + 1, dc + 1]:
                all_nb &= pad[1 + dr : 1 + dr + nrow, 1 + dc : 1 + dc + ncol]
    edge = a.copy()
    interior = np.zeros_like(a)
    interior[1:-1, 1:-1] = True
    edge[interior & all_nb] = False
    return edge


def fill_depressions(
    elevtn,
    outlets="edge",
    idxs_pit=None,
    nodata=-9999.0,
    max_depth=-1.0,
    elv_max=None,
    connectivity=8,
):
    """Fill local depressions and derive D8 flow directions.

    Exact Wang & Liu (2006) priority-flood (upstream pyflwdir
    ``dem.py:18-143``): seeds at valid-edge cells ('edge'), the single lowest
    edge cell ('min') or user pits; the D8 direction of each cell points to
    the cell that popped it. Runs the native kernel
    (``csrc/host_kernels.cpp::priority_flood``). Returns ``(filled, d8)``.
    """
    from .runtime import priority_flood

    return priority_flood(
        np.asarray(elevtn),
        outlets=outlets,
        idxs_pit=idxs_pit,
        nodata=nodata,
        max_depth=max_depth,
        elv_max=elv_max,
        connectivity=connectivity,
    )


def _round_odd(s, e):
    """``s``, the rounded sum whose exact error is ``e``, rounded to odd:
    moved one step toward ``e`` where the sum was inexact and ``s`` is
    even."""
    bits = s.view(torch.int64 if s.dtype == torch.float64 else torch.int32)
    inf = torch.full_like(s, torch.inf)
    step = torch.nextafter(s, torch.where(e > 0, inf, -inf))
    return torch.where((e != 0) & ((bits & 1) == 0), step, s)


def _one_plus_square(r):
    """``1 + r * r`` for r in [0, 1] rounded once, as a fused multiply-add
    gives it: XLA's CPU code contracts ``jnp.hypot``'s ``1 + square(r)``
    into one. float32: the exact float64 sum rounded to odd, then to
    float32; float64: Boldo and Melquiond's emulation (the exact product
    by Dekker's split, an exact sum, the low parts rounded to odd, one
    last rounding). Each operation a tensor operation of its own, so no
    compiler contracts them in turn."""
    if r.dtype == torch.float32:
        r64 = r.to(torch.float64)
        p = r64 * r64  # exact: 48 bits
        s = 1 + p
        return _round_odd(s, (1 - s) + p).to(torch.float32)
    uh = r * r
    c = r * 134217729.0  # 2^27 + 1
    hi = c - (c - r)
    lo = r - hi
    ul = ((hi * hi - uh) + (2 * hi) * lo) + lo * lo  # r * r == uh + ul
    th = 1 + uh
    tl = (1 - th) + uh  # 1 + uh == th + tl
    v = tl + ul
    vb = v - tl
    ev = (tl - (v - vb)) + (ul - vb)  # tl + ul == v + ev
    return th + _round_odd(v, ev)


def _sqrt(x):
    """Square root rounded correctly: ``torch.sqrt`` on the card (IEEE),
    numpy's on the host, where PyTorch's vectorised CPU kernel can be an
    ulp off."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _hypot(x, y):
    """``jnp.hypot``'s formula: ``max * sqrt(1 + (min / max)^2)``, 0 where
    max is 0, +inf where either input is +inf, with ``1 + (min / max)^2``
    rounded once (:func:`_one_plus_square`). ``torch.hypot`` calls the C
    library's, which can differ from it in the last bit."""
    x, y = x.abs(), y.abs()
    inf = torch.isposinf(x) | torch.isposinf(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    r = lo / torch.where(zero, torch.ones_like(hi), hi)
    out = torch.where(zero, hi, hi * _sqrt(_one_plus_square(r)))
    return torch.where(inf, torch.full_like(out, torch.inf), out)


def slope(elevtn, nodata=-9999.0, latlon=False, transform=IDENTITY, device=None):
    """Local gradient from the 3x3 window's second-order partial
    derivatives (upstream pyflwdir ``dem.py:229-296``): window entries off
    the grid or at nodata take the centre value. One stencil pass on
    ``device`` (None: the card); returns a float32 tensor, ``nodata`` at
    nodata cells. The steps keep the JAX package's dtypes: the stencil in
    ``elevtn``'s float type, divided by the cell size in that type; on a
    latlon grid divided by the float64 metres a degree of each row, so
    float64 from there; the hypotenuse by :func:`_hypot`."""
    dev = resolve_device(device)
    z = torch.as_tensor(elevtn, device=dev)
    if not z.dtype.is_floating_point:
        z = z.to(torch.float32)
    nrow, ncol = z.shape
    xres, yres, north = transform[0], transform[4], transform[5]
    nan = isinstance(nodata, float) and np.isnan(nodata)
    bad = torch.isnan(z) if nan else (z == nodata)
    pad = torch.nn.functional.pad(z[None, None], (1, 1, 1, 1), value=float(nodata))[0, 0]
    pad_bad = torch.nn.functional.pad(bad[None, None].to(torch.uint8), (1, 1, 1, 1),
                                      value=1)[0, 0].bool()

    def nb(dr, dc):
        v = pad[1 + dr : 1 + dr + nrow, 1 + dc : 1 + dc + ncol]
        b = pad_bad[1 + dr : 1 + dr + nrow, 1 + dc : 1 + dc + ncol]
        return torch.where(b, z, v)

    # divide by a device scalar: a Python scalar divisor is taken as a
    # multiplication by its reciprocal on the card, another rounding
    def div(a, b):
        return a / torch.tensor(b, dtype=a.dtype, device=dev)

    dzdx = div((nb(-1, -1) + 2 * nb(0, -1) + nb(1, -1))
               - (nb(-1, 1) + 2 * nb(0, 1) + nb(1, 1)), 8 * abs(xres))
    dzdy = div((nb(-1, -1) + 2 * nb(-1, 0) + nb(-1, 1))
               - (nb(1, -1) + 2 * nb(1, 0) + nb(1, 1)), 8 * abs(yres))
    if latlon:
        lat = north + (np.arange(nrow) + 0.5) * yres
        deg_x = torch.as_tensor(geodesy.degree_metres_x(lat), device=dev)[:, None]
        deg_y = torch.as_tensor(geodesy.degree_metres_y(lat), device=dev)[:, None]
        slp = _hypot(dzdx.to(torch.float64) / deg_x, dzdy.to(torch.float64) / deg_y)
    else:
        slp = _hypot(dzdx, dzdy)
    slp = torch.where(bad, torch.tensor(float(nodata), dtype=slp.dtype, device=dev), slp)
    return slp.to(torch.float32)


def height_above_nearest_drain(idxs_ds, drain, elevtn):
    """HAND: the drop from each cell to the first drain cell (else the pit)
    downstream of it; 0 at drain cells, -9999 at missing cells. Tensors in,
    a tensor of ``elevtn``'s float dtype (float32 for integers) out."""
    from .ops import graph

    drain = drain != 0
    z = elevtn if elevtn.dtype.is_floating_point else elevtn.to(torch.float32)
    hand = z - z[graph.reach(idxs_ds, drain)]
    hand = torch.where(drain, torch.zeros_like(hand), hand)
    return torch.where(idxs_ds >= 0, hand, torch.full_like(hand, -9999.0))


def floodplains(idxs_ds, elevtn, uparea, upa_min=1000.0, b=0.3):
    """GFPLAIN floodplains (upstream pyflwdir ``dem.py:333-379``): a cell
    belongs to the floodplain of the first stream cell t downstream of it
    (``uparea >= upa_min``) when the largest elevation on its path to t, t
    left out, stays within ``uparea[t] ** b`` of t's (float32). Tensors
    in, on ``idxs_ds``' device: one ``reach`` and one path maximum. Returns
    int8: 1 floodplain or stream, 0 not, -1 missing."""
    from .ops import graph

    valid = idxs_ds >= 0
    stream = (uparea >= upa_min) & valid
    t = graph.reach(idxs_ds, stream)
    z = elevtn.to(torch.float32)
    pathmax = graph.path_reduce(idxs_ds, z, stop=stream, op="max")
    thresh = uparea.to(torch.float32)[t] ** torch.tensor(b, dtype=torch.float32,
                                                          device=idxs_ds.device)
    ok = stream[t] & (pathmax - z[t] <= thresh)
    fld = (stream | ok).to(torch.int8)
    return torch.where(valid, fld, torch.full_like(fld, -1))


def _headwater_first_order(rank_np):
    """The valid cells ordered up- to downstream: decreasing rank, stable."""
    valid = rank_np >= 0
    order = np.argsort(-rank_np[valid], kind="stable")
    return np.where(valid)[0][order]


def adjust_elevation(idxs_ds, rank, elevtn):
    """Hydrologically adjusted elevation along the streamlines (upstream
    pyflwdir ``dem.py:147-225``): from each headwater down to the first
    cell already fixed, the profile repaired at the least dig, fill or
    flatten cost, in decreasing rank order; the native sweep
    (``runtime.adjust_elevation``) on the host. Numpy arrays in, a float64
    array out."""
    from .runtime import adjust_elevation as _native

    order = _headwater_first_order(np.asarray(rank).ravel())
    return _native(np.asarray(idxs_ds), order, np.asarray(elevtn))


def _adjust_elevation_profile(elevtn):
    """Least-modification repair of one up- to downstream profile
    (``runtime.repair_profile``), in ``elevtn``'s dtype."""
    from .runtime import repair_profile as _native

    return _native(np.asarray(elevtn)).astype(np.asarray(elevtn).dtype)


def _local_d4(idx0, idx_ds, ncol):
    """The D4 neighbours bridging a diagonal D8 link ``idx0 -> idx_ds``
    (the vertical one first where the step has dr == dc), or all four D4
    neighbours where ``idx_ds == idx0`` (a pit); upstream pyflwdir
    ``dem.py:383-402``."""
    if idx_ds == idx0:
        return np.asarray([idx0 - 1, idx0 + ncol, idx0 + 1, idx0 - ncol])
    dr = idx_ds // ncol - idx0 // ncol
    dc = idx_ds % ncol - idx0 % ncol
    vert, horz = idx0 + dr * ncol, idx0 + dc
    return np.asarray([vert, horz] if dr == dc else [horz, vert])


def dig_4connectivity(idxs_ds, rank, elevtn, shape, mask=None, nodata=-9999, dz_min=1e-3):
    """Dig a D4-connected channel along every diagonal D8 link (upstream
    pyflwdir ``dem.py:405-439``), up- to downstream by decreasing rank, in
    the native sweep (``runtime.dig_d4``) on the host. Numpy arrays in, a
    float64 array out."""
    from .runtime import dig_d4 as _native

    order = _headwater_first_order(np.asarray(rank).ravel())
    return _native(
        np.asarray(idxs_ds),
        order,
        shape,
        np.asarray(elevtn),
        mask=None if mask is None else np.asarray(mask),
        nodata=nodata,
        dz_min=dz_min,
    )
