"""Conversion between D8 and LDD flow-direction codes (numpy).

One 256-entry table gather per raster, as in the JAX package's
``codecs/convert.py`` (parity: upstream pyflwdir ``core_conversion.py:11-28``):
each code maps to the code of the same step, pits to pits, nodata and
unknown codes to the target's nodata.
"""

from __future__ import annotations

import numpy as np

from . import d8 as core_d8
from . import ldd as core_ldd

__all__ = ["d8_to_ldd", "ldd_to_d8"]

_D8_TO_LDD = np.full(256, core_ldd._mv, dtype=np.uint8)
_D8_TO_LDD[core_d8._ds.ravel()] = core_ldd._ds.ravel()
_D8_TO_LDD[core_d8._pv[1]] = core_ldd._pv  # 255 (land pit) -> 5
_D8_TO_LDD[core_d8._mv] = core_ldd._mv

_LDD_TO_D8 = np.full(256, core_d8._mv, dtype=np.uint8)
_LDD_TO_D8[core_ldd._ds.ravel()] = core_d8._ds.ravel()
_LDD_TO_D8[core_ldd._pv] = core_d8._pv[0]  # 5 -> 0
_LDD_TO_D8[core_ldd._mv] = core_d8._mv


def d8_to_ldd(flwdir):
    """The LDD raster of a D8 raster. Parity: core_conversion.py:11-18."""
    return _D8_TO_LDD[np.asarray(flwdir, dtype=np.uint8)]


def ldd_to_d8(flwdir):
    """The D8 raster of an LDD raster. Parity: core_conversion.py:21-28."""
    return _LDD_TO_D8[np.asarray(flwdir, dtype=np.uint8)]
