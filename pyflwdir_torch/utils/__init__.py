"""Geospatial utilities: affine transforms, geodesy, grid tools."""

from .affine import (
    IDENTITY,
    Affine,
    array_bounds,
    transform_from_bounds,
    transform_from_origin,
)
from .geodesy import (
    AREA_FACTORS,
    affine_to_coords,
    area_grid,
    cellarea,
    coords_to_idxs,
    degree_metres_x,
    degree_metres_y,
    distance,
    distance_grid,
    idxs_to_coords,
    reggrid_area,
    reggrid_dx,
    reggrid_dy,
    rowcol,
    xy,
)

__all__ = [
    "Affine",
    "IDENTITY",
    "transform_from_origin",
    "transform_from_bounds",
    "array_bounds",
    "xy",
    "rowcol",
    "idxs_to_coords",
    "coords_to_idxs",
    "affine_to_coords",
    "reggrid_area",
    "reggrid_dx",
    "reggrid_dy",
    "area_grid",
    "cellarea",
    "degree_metres_x",
    "degree_metres_y",
    "distance",
    "distance_grid",
    "AREA_FACTORS",
]
