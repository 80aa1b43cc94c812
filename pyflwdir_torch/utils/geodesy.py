"""Geodesy and raster coordinate helpers.

Vectorized (numpy) equivalents of the reference's geodesy/transform math
(upstream pyflwdir ``gis_utils.py:183-487``): WGS84-approximate
degree lengths, spherical cell areas, regular-grid dx/dy/area grids, and
cell-to-cell distances. All functions are pure elementwise math over whole
grids — they run once on the host and feed the device kernels as dense
input arrays.
"""

from __future__ import annotations

import numpy as np

from .affine import IDENTITY, Affine

_R = 6371e3  # earth radius [m], matches reference gis_utils.py:10
AREA_FACTORS = {"m2": 1.0, "ha": 1e4, "km2": 1e6, "cell": 1}

__all__ = [
    "xy",
    "rowcol",
    "idxs_to_coords",
    "coords_to_idxs",
    "affine_to_coords",
    "reggrid_dx",
    "reggrid_dy",
    "reggrid_area",
    "area_grid",
    "cellarea",
    "degree_metres_x",
    "degree_metres_y",
    "distance",
    "distance_grid",
]


def xy(transform: Affine, rows, cols, offset="center"):
    """x/y coordinates of pixels at rows/cols (reference gis_utils.py:183-223)."""
    rows, cols = np.asarray(rows), np.asarray(cols)
    offsets = {
        "center": (0.5, 0.5),
        "ul": (0.0, 0.0),
        "ur": (1.0, 0.0),
        "ll": (0.0, 1.0),
        "lr": (1.0, 1.0),
    }
    if offset not in offsets:
        raise ValueError("Invalid offset")
    coff, roff = offsets[offset]
    return transform * Affine.translation(coff, roff) * (cols, rows)


def rowcol(transform: Affine, xs, ys, op=np.floor, precision=None):
    """rows/cols of pixels containing x/y (reference gis_utils.py:226-261)."""
    xs, ys = np.asarray(xs), np.asarray(ys)
    if precision is None:
        eps = 0.0
    else:
        eps = 10.0**-precision * (1.0 - 2.0 * op(0.1))
    fcols, frows = (~transform) * (xs + eps, ys - eps)
    return op(frows).astype(int), op(fcols).astype(int)


def idxs_to_coords(idxs, transform: Affine, shape, offset="center"):
    """Coordinates of linear raster indices (reference gis_utils.py:264-298)."""
    idxs = np.asarray(idxs).astype(int)
    size = shape[0] * shape[1]
    if np.any(np.logical_or(idxs < 0, idxs >= size)):
        raise IndexError("idxs coordinates outside domain")
    ncol = shape[1]
    return xy(transform, idxs // ncol, idxs % ncol, offset=offset)


def coords_to_idxs(xs, ys, transform: Affine, shape, op=np.floor, precision=None):
    """Linear indices of coordinates (reference gis_utils.py:301-338)."""
    nrow, ncol = shape
    rows, cols = rowcol(transform, xs, ys, op=op, precision=precision)
    inside = (rows >= 0) & (rows < nrow) & (cols >= 0) & (cols < ncol)
    if not np.all(inside):
        raise IndexError("XY coordinates outside domain")
    return rows * ncol + cols


def affine_to_coords(affine: Affine, shape):
    """Pixel-center x/y axes of a raster (reference gis_utils.py:342-359)."""
    height, width = shape
    x_coords, _ = affine * (np.arange(width) + 0.5, np.zeros(width) + 0.5)
    _, y_coords = affine * (np.zeros(height) + 0.5, np.arange(height) + 0.5)
    return x_coords, y_coords


def degree_metres_y(lat):
    """Metres per degree of latitude at latitude ``lat`` [deg].

    Cosine-series approximation, parity: reference gis_utils.py:415-431.
    """
    radlat = np.radians(lat)
    return (
        111132.92
        - 559.82 * np.cos(2.0 * radlat)
        + 1.175 * np.cos(4.0 * radlat)
        - 0.0023 * np.cos(6.0 * radlat)
    )


def degree_metres_x(lat):
    """Metres per degree of longitude at latitude ``lat`` [deg].

    Cosine-series approximation, parity: reference gis_utils.py:434-448.
    """
    radlat = np.radians(lat)
    return (
        111412.84 * np.cos(radlat)
        - 93.5 * np.cos(3.0 * radlat)
        + 0.118 * np.cos(5.0 * radlat)
    )


def cellarea(lat, xres, yres):
    """Spherical-cap cell area [m2] at cell-centre latitude (gis_utils.py:405-412)."""
    l1 = np.radians(lat - np.abs(yres) / 2.0)
    l2 = np.radians(lat + np.abs(yres) / 2.0)
    dx = np.radians(np.abs(xres))
    return _R**2 * dx * (np.sin(l2) - np.sin(l1))


def reggrid_dx(lats, lons):
    """Cell widths [m] for a regular lat/lon grid (gis_utils.py:363-368)."""
    xres = np.abs(np.mean(np.diff(lons)))
    dx = degree_metres_x(lats) * xres
    return dx[:, None] * np.ones((lats.size, lons.size), dtype=lats.dtype)


def reggrid_dy(lats, lons):
    """Cell heights [m] for a regular lat/lon grid (gis_utils.py:371-376)."""
    yres = np.abs(np.mean(np.diff(lats)))
    dy = degree_metres_y(lats) * yres
    return dy[:, None] * np.ones((lats.size, lons.size), dtype=lats.dtype)


def reggrid_area(lats, lons):
    """Cell areas [m2] for a regular lat/lon grid (gis_utils.py:379-385)."""
    xres = np.abs(np.mean(np.diff(lons)))
    yres = np.abs(np.mean(np.diff(lats)))
    area = np.ones((lats.size, lons.size), dtype=np.float32)
    return cellarea(lats, xres, yres)[:, None] * area


def area_grid(transform: Affine, shape, latlon=False, unit="m2"):
    """Regular grid of cell areas (reference gis_utils.py:388-402)."""
    unit = str(unit).lower()
    if unit not in AREA_FACTORS:
        fstr = '", "'.join(AREA_FACTORS.keys())
        raise ValueError(f'Unknown unit: {unit}, select from "{fstr}".')
    if unit == "cell":
        return np.ones(shape, dtype=np.int32)
    if latlon:
        lon, lat = affine_to_coords(transform, shape)
        return reggrid_area(lat, lon) / AREA_FACTORS[unit]
    area0 = abs(transform[0] * transform[4]) / AREA_FACTORS[unit]
    return np.full(shape, area0, dtype=np.float32)


def distance(idx0, idx1, ncol, latlon=False, transform=IDENTITY):
    """Length between (arrays of) linear indices idx0/idx1 on a regular raster.

    Vectorized parity with reference gis_utils.py:451-487: for latlon grids
    the degree lengths are evaluated at the mean latitude of the two rows;
    note the reference swaps xres/yres in the projected branch
    (``dy = xres; dx = yres`` at gis_utils.py:484-485) which is identical
    for square cells — we reproduce it for exactness.
    """
    idx0 = np.asarray(idx0)
    idx1 = np.asarray(idx1)
    xres, yres, north = transform[0], transform[4], transform[5]
    r0 = idx0 // ncol
    r1 = idx1 // ncol
    dr = np.abs(r1 - r0)
    dc = np.abs((idx1 % ncol) - (idx0 % ncol))
    if latlon:
        lat = north + (r0 + r1) / 2.0 * yres
        dy = np.where(dr == 0, 0.0, degree_metres_y(lat) * yres)
        dx = np.where(dc == 0, 0.0, degree_metres_x(lat) * xres)
    else:
        dy = np.full(dr.shape, xres)
        dx = np.full(dc.shape, yres)
    return np.hypot(dy * dr, dx * dc)


def distance_grid(idxs_ds, shape, latlon=False, transform=IDENTITY):
    """Per-cell distance to the next downstream cell (0 at pits/missing).

    Dense-grid equivalent of calling reference ``gis_utils.distance`` per
    cell (as done in flwdir.py distnc / subgrid length kernels).
    """
    n = shape[0] * shape[1]
    idxs = np.arange(n, dtype=idxs_ds.dtype)
    ds = np.where(idxs_ds < 0, idxs, idxs_ds)
    return distance(idxs, ds, shape[1], latlon=latlon, transform=transform).astype(
        np.float64
    )
