"""Flow-direction codecs: D8, LDD and NEXTXY, and conversions (numpy).

The ``FTYPES`` registry mirrors the reference's duck-typed codec interface
(upstream pyflwdir ``pyflwdir.py:26-30``): each codec module exposes
``_ftype, _ds, _us, _mv, _pv, _all`` plus ``from_array``, ``to_array``,
``isvalid``, ``ispit``, ``isnodata``.
"""

from . import convert, d8, ldd, nextxy
from .convert import d8_to_ldd, ldd_to_d8
from .nextxy import read_nextxy

#: registry of flow-direction types (parity: reference pyflwdir.py:26-30)
FTYPES = {
    d8._ftype: d8,
    ldd._ftype: ldd,
    nextxy._ftype: nextxy,
}


def infer_ftype(flwdir):
    """Infer the flow-direction type from a 2-D/3-D raster.

    Parity: reference pyflwdir.py:39-48.
    """
    for ftype, fd in FTYPES.items():
        if fd.isvalid(flwdir):
            return ftype
    raise ValueError("The flow direction type could not be inferred.")


__all__ = [
    "FTYPES",
    "infer_ftype",
    "d8",
    "ldd",
    "nextxy",
    "convert",
    "d8_to_ldd",
    "ldd_to_d8",
    "read_nextxy",
]
