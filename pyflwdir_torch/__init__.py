"""pyflwdir_torch — raster hydrography on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package in this repository, slice by slice. Ported so far:
D8/LDD/NEXTXY codecs, the host depression fill, the DFS plan, the
single-chunk router accumulation (``ops.accel.AccelPlan``, hand-written CUDA
kernels in ``csrc/accel_kernels.cu``), the hierarchical tile plan upward and
downward (``ops.tile_plan.TilePlan``, ``csrc/tile_kernels.cu``) and the
pointer-doubling graph primitives, behind ``from_array`` ->
``FlwdirRaster.upstream_area`` / ``accuflux`` / ``rank`` / ``basins`` /
``stream_distance`` / ``hand`` / ``fillnodata(direction="up")``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
GPU and no ``device`` they raise.
"""

from . import basins, codecs, dem, kernels, ops, runtime, streams, utils
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
    "basins",
    "codecs",
    "dem",
    "kernels",
    "ops",
    "runtime",
    "streams",
    "utils",
]
