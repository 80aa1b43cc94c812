"""pyflwdir_torch — raster hydrography on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package in this repository, slice by slice. Ported so far:
D8/LDD/NEXTXY codecs, the host depression fill, the DFS plan, the
single-chunk router accumulation (``ops.accel.AccelPlan``, hand-written CUDA
kernels in ``csrc/accel_kernels.cu``) and pointer-doubling rank/roots, behind
``from_array`` -> ``FlwdirRaster.upstream_area`` / ``accuflux`` / ``rank``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
GPU and no ``device`` they raise.
"""

from . import codecs, dem, kernels, ops, runtime, utils
from ._backend import default_device, has_cuda
from .dem import fill_depressions
from .flwdir import Flwdir
from .raster import FlwdirRaster, from_array

__all__ = [
    "Flwdir",
    "FlwdirRaster",
    "from_array",
    "fill_depressions",
    "default_device",
    "has_cuda",
    "codecs",
    "dem",
    "kernels",
    "ops",
    "runtime",
    "utils",
]
