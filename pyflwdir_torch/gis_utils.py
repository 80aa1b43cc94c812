"""The geospatial helpers under the names of pyflwdir's ``gis_utils``
module: transform math (:mod:`utils.affine`), coordinates and WGS84 lengths
and areas (:mod:`utils.geodesy`), and :mod:`gridtools` (``spread2d``,
``features``, ``get_edge``)."""

from .gridtools import features, get_edge, spread2d
from .utils.affine import Affine, array_bounds, transform_from_bounds, transform_from_origin
from .utils.geodesy import (
    affine_to_coords,
    area_grid,
    cellarea,
    coords_to_idxs,
    degree_metres_x,
    degree_metres_y,
    distance,
    idxs_to_coords,
    reggrid_area,
    reggrid_dx,
    reggrid_dy,
    rowcol,
    xy,
)

__all__ = [
    "Affine",
    "transform_from_origin",
    "transform_from_bounds",
    "array_bounds",
    "xy",
    "rowcol",
    "idxs_to_coords",
    "coords_to_idxs",
    "affine_to_coords",
    "reggrid_area",
    "reggrid_dy",
    "reggrid_dx",
    "area_grid",
    "cellarea",
    "degree_metres_x",
    "degree_metres_y",
    "distance",
    "get_edge",
    "spread2d",
    "features",
]
