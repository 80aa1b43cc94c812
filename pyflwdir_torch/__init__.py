"""pyflwdir_torch — raster hydrography on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package in this repository, slice by slice. Ported so far:
D8/LDD/NEXTXY codecs, the host depression fill and the device one
(``ops.fill``, kernel F1 in ``csrc/fill_kernels.cu``) behind ``from_dem``,
the DFS plan, the single-chunk router accumulation (``ops.accel.AccelPlan``,
hand-written CUDA kernels in ``csrc/accel_kernels.cu``) and the large-graph
one on the same kernels (``ops.accel_big.BigAccelPlan``, up to 2^28 slots),
the hierarchical tile plan upward, downward and band by band
(``ops.tile_plan.TilePlan``, ``csrc/tile_kernels.cu``), saved and loaded
(``ops.plan_io``, ``FlwdirRaster.save_plans`` / ``load_plans``, which also
read the JAX package's plan directories), the pointer-doubling graph
primitives and stream order (``ops.order``: Strahler through the tile
plan above 2^21 cells), behind
``from_array`` / ``from_dem`` -> ``FlwdirRaster.upstream_area`` /
``accuflux`` / ``rank`` / ``basins`` / ``stream_distance`` / ``hand`` /
``fillnodata`` / ``stream_order`` / ``subbasins_*`` / ``interbasin_mask``
/ ``inflow_idxs`` / ``outflow_idxs``, and sharded over the ranks of a
``torch.distributed`` process group (``parallel``: ``make_mesh``,
``build_sharded_plan``, ``tiled_accumulate(method="plan")``,
``TilePlan.accumulate_sharded`` / ``accumulate_down_sharded``). The object
surface around them: the window gathers and the native walks
(``ops.walk``: ``path``, ``snap``, snapping to streams in ``add_pits`` and
``basins``), the moving windows and upstream sums (``arithmetics``), the
region measurements (``regions``: ``basin_bounds``, ``basin_outlets``),
``gridtools`` / ``gis_utils`` (``spread2d``, features, ``streams``,
``vectorize``), directory checkpoints (``checkpoint``), ``dump`` / ``load``
and ``from_dataframe``. Upscaling (``upscale``: DMM, EAM, EAM+, IHU and the
banded IHU, the maps over every pixel on the device), unit catchments and
the sub-grid river statistics (``subgrid``), estuaries and river depths
(``rivers``), and the rest of ``dem`` (``slope``, ``floodplains``, the
elevation adjustment and D4 digging), behind ``FlwdirRaster.upscale`` /
``ucat_*`` / ``subgrid_*`` / ``floodplains`` / ``dem_dig_d4`` and
``Flwdir.dem_adjust`` / ``classify_estuaries`` / ``river_depth``. The
public names are the JAX package's; ``default_device``, ``has_cuda``,
``kernels`` and ``runtime`` are the port's own, outside ``__all__``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
GPU and no ``device`` they raise.
"""

__version__ = "0.1.0"

from . import (
    arithmetics,
    basins,
    checkpoint,
    codecs,
    dem,
    gis_utils,
    gridtools,
    kernels,
    ops,
    parallel,
    regions,
    rivers,
    runtime,
    streams,
    subgrid,
    upscale,
    utils,
)
from ._backend import default_device, has_cuda
from .codecs import FTYPES, d8_to_ldd, ldd_to_d8, read_nextxy
from .dem import fill_depressions, slope
from .flwdir import Flwdir, from_dataframe
from .gridtools import spread2d
from .raster import FlwdirRaster, from_array, from_dem
from .utils import Affine
from .utils.geodesy import affine_to_coords, area_grid, coords_to_idxs, idxs_to_coords

__all__ = [
    "Flwdir",
    "FlwdirRaster",
    "from_array",
    "from_dem",
    "from_dataframe",
    "read_nextxy",
    "d8_to_ldd",
    "ldd_to_d8",
    "fill_depressions",
    "slope",
    "spread2d",
    "area_grid",
    "affine_to_coords",
    "idxs_to_coords",
    "coords_to_idxs",
    "Affine",
    "FTYPES",
    "codecs",
    "ops",
    "utils",
    "streams",
    "basins",
    "dem",
    "upscale",
    "subgrid",
    "arithmetics",
    "rivers",
    "regions",
    "gridtools",
    "gis_utils",
    "checkpoint",
    "parallel",
    "__version__",
]
