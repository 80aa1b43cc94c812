"""Minimal affine transform for raster georeferencing.

A self-contained replacement for the ``affine.Affine`` class used by the
reference (upstream pyflwdir ``gis_utils.py:7``), covering only the
operations this framework needs: construction, composition, inversion,
application to (col, row) coordinate arrays, and the rasterio-style
``transform_from_origin``/``transform_from_bounds`` helpers
(reference ``gis_utils.py:153-180``).

Coefficient order follows the ``affine`` package convention::

    x = a * col + b * row + c
    y = d * col + e * row + f
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Affine",
    "IDENTITY",
    "transform_from_origin",
    "transform_from_bounds",
    "array_bounds",
]


class Affine(tuple):
    """2-D affine transform (a, b, c, d, e, f)."""

    def __new__(cls, a, b, c, d, e, f):
        return super().__new__(cls, (float(a), float(b), float(c), float(d), float(e), float(f)))

    def __getnewargs__(self):
        return tuple(self)

    # -- named coefficients -------------------------------------------------
    @property
    def a(self):
        return self[0]

    @property
    def b(self):
        return self[1]

    @property
    def c(self):
        return self[2]

    @property
    def d(self):
        return self[3]

    @property
    def e(self):
        return self[4]

    @property
    def f(self):
        return self[5]

    @property
    def xoff(self):
        return self[2]

    @property
    def yoff(self):
        return self[5]

    # -- constructors -------------------------------------------------------
    @classmethod
    def identity(cls) -> "Affine":
        return cls(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    @classmethod
    def translation(cls, xoff, yoff) -> "Affine":
        return cls(1.0, 0.0, xoff, 0.0, 1.0, yoff)

    @classmethod
    def scale(cls, sx, sy=None) -> "Affine":
        if sy is None:
            sy = sx
        return cls(sx, 0.0, 0.0, 0.0, sy, 0.0)

    # -- algebra ------------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Affine):
            a, b, c, d, e, f = self
            a2, b2, c2, d2, e2, f2 = other
            return Affine(
                a * a2 + b * d2,
                a * b2 + b * e2,
                a * c2 + b * f2 + c,
                d * a2 + e * d2,
                d * b2 + e * e2,
                d * c2 + e * f2 + f,
            )
        # apply to a (col, row) pair (scalars or arrays)
        col, row = other
        a, b, c, d, e, f = self
        col = np.asarray(col)
        row = np.asarray(row)
        x = a * col + b * row + c
        y = d * col + e * row + f
        if x.ndim == 0:
            return float(x), float(y)
        return x, y

    def __invert__(self) -> "Affine":
        a, b, c, d, e, f = self
        det = a * e - b * d
        if det == 0.0:
            raise ValueError("Affine transform is not invertible")
        ia, ib = e / det, -b / det
        id_, ie = -d / det, a / det
        ic = -(ia * c + ib * f)
        if_ = -(id_ * c + ie * f)
        return Affine(ia, ib, ic, id_, ie, if_)

    def __repr__(self):
        a, b, c, d, e, f = self
        return f"Affine({a}, {b}, {c}, {d}, {e}, {f})"


#: N->S oriented identity transform (matches reference gis_utils.py:13)
IDENTITY = Affine(1.0, 0.0, 0.0, 0.0, -1.0, 0.0)


def transform_from_origin(west, north, xsize, ysize) -> Affine:
    """Affine transform from upper-left corner and pixel sizes.

    Parity: reference ``gis_utils.py:153-159``.
    """
    return Affine.translation(west, north) * Affine.scale(xsize, -ysize)


def transform_from_bounds(west, south, east, north, width, height) -> Affine:
    """Affine transform from bounds and raster width/height.

    Parity: reference ``gis_utils.py:162-170``.
    """
    return Affine.translation(west, north) * Affine.scale(
        (east - west) / width, (south - north) / height
    )


def array_bounds(height, width, transform: Affine):
    """(west, south, east, north) bounds of an array.

    Parity: reference ``gis_utils.py:173-180``.
    """
    w, n = transform.xoff, transform.yoff
    e, s = transform * (width, height)
    return w, s, e, n
