"""FlwdirRaster and ``from_array``: the raster flow-direction object, the
subset ported so far (shape, mask, transform, area, rank, upstream area and
accumulation, through the tile plan above 2^21 cells)."""

from __future__ import annotations

import numpy as np
import torch

from .codecs import FTYPES, infer_ftype
from .flwdir import Flwdir
from .utils import geodesy
from .utils.affine import IDENTITY, Affine

__all__ = ["FlwdirRaster", "from_array"]


def from_array(
    data,
    ftype="infer",
    check_ftype=True,
    mask=None,
    transform=IDENTITY,
    latlon=False,
    device=None,
    **kwargs,
):
    """Parse a flow direction raster to an actionable FlwdirRaster.

    ``device`` names where the graph and its plans live; ``None`` means
    CUDA, and raises when no GPU is present.
    """
    if ftype == "infer":
        ftype = infer_ftype(data)
        check_ftype = False
    if ftype == "nextxy":
        shape = data[0].shape
        ndim = data[0].ndim
    else:
        data = np.asarray(data)
        ndim = data.ndim
        shape = data.shape
    if ndim != 2:
        raise ValueError("The FlwdirRaster should be 2 dimensional")

    fd = FTYPES[ftype]
    if check_ftype and not fd.isvalid(data):
        raise ValueError(f'The flow direction data with type "{ftype}" is invalid.')
    if mask is not None:
        mask = np.asarray(mask)
        if mask.shape != shape:
            raise ValueError('"mask" shape does not match with data shape')
        if ftype == "nextxy":
            data = tuple(np.where(mask != 0, d, fd._mv) for d in data)
        else:
            data = np.where(mask != 0, data, fd._mv)

    idxs_ds, idxs_pit, _ = fd.from_array(data, dtype=np.int64)
    first = data[0] if ftype == "nextxy" else data
    idxs_outlet = idxs_pit[fd.ispit(np.asarray(first).flat[idxs_pit])]
    return FlwdirRaster(
        idxs_ds=idxs_ds,
        idxs_pit=idxs_pit,
        idxs_outlet=idxs_outlet,
        shape=shape,
        ftype=ftype,
        transform=transform,
        latlon=latlon,
        device=device,
        **kwargs,
    )


class FlwdirRaster(Flwdir):
    """Flow direction raster array parsed to general actionable format."""

    # above this size accumulation runs through the hierarchical tile plan
    # (ops/tile_plan.py), as in the JAX package
    _TILE_PLAN_MIN = 1 << 21

    def __init__(
        self,
        idxs_ds,
        shape,
        ftype,
        idxs_pit=None,
        idxs_outlet=None,
        nnodes=None,
        transform=IDENTITY,
        latlon=False,
        cache=True,
        device=None,
    ):
        super().__init__(
            idxs_ds=idxs_ds,
            idxs_pit=idxs_pit,
            idxs_outlet=idxs_outlet,
            nnodes=nnodes,
            cache=cache,
            device=device,
        )
        if ftype not in FTYPES:
            ftypes_str = '" ,"'.join(list(FTYPES.keys()))
            raise ValueError(
                f'Unknown flow direction type: "{ftype}", select from {ftypes_str}'
            )
        self.ftype = ftype
        if int(np.multiply(*np.array(shape, np.uint64))) != self.size:
            raise ValueError(
                f"Invalid FlwdirRaster: shape {shape} does not match size {self.size}"
            )
        self.shape = tuple(shape)
        self.set_transform(transform, latlon)

    def set_transform(self, transform, latlon=False):
        """Set the affine transform."""
        if not isinstance(transform, Affine):
            try:
                transform = Affine(*transform)
            except TypeError:
                raise ValueError("Invalid transform.")
        self.transform = transform
        self.latlon = bool(latlon)

    @property
    def area(self):
        """Cell area [m2]."""
        if "area" in self._cached:
            return self._cached["area"]
        area = geodesy.area_grid(self.transform, self.shape, self.latlon, unit="m2")
        if self.cache:
            self._cached["area"] = area
        return area

    def _tile_plan(self):
        """Build (once) and cache the hierarchical tile plan. Where the JAX
        package's build fails and it falls back to host sweeps, this raises
        NotImplementedError: the port has no such fallback yet."""
        if "tile_plan" not in self._cached:
            from .ops.tile_plan import build_tile_plan

            try:
                self._cached["tile_plan"] = build_tile_plan(
                    self._idxs_ds, self.shape, device=self.device
                )
            except ValueError as e:
                raise NotImplementedError(
                    f"tile plan build failed ({e}); the host-sweep fallback of the "
                    "JAX package is queued for a later slice of the PyTorch port"
                ) from e
        return self._cached["tile_plan"]

    def _accumulate_dev(self, data):
        """Flow accumulation through the cached tile plan above 2^21 cells,
        the single-chunk engines (Flwdir._accumulate_dev) up to that."""
        if self.size <= self._TILE_PLAN_MIN:
            return super()._accumulate_dev(data)
        return self._tile_plan().accumulate(data)

    def upstream_area(self, unit="cell"):
        """Upstream area map: -9999 outside the mask; int32 in cells, float64
        in an area unit."""
        unit = str(unit).lower()
        if unit not in geodesy.AREA_FACTORS:
            fstr = '", "'.join(geodesy.AREA_FACTORS.keys())
            raise ValueError(f'Unknown unit: {unit}, select from "{fstr}".')
        if unit == "cell":
            area = np.ones(self.size, dtype=np.int32)
        else:
            area = np.asarray(self.area).ravel() / geodesy.AREA_FACTORS[unit]
        uparea = self._accumulate_dev(torch.as_tensor(area, device=self.device))
        uparea = np.where(self.mask, uparea.cpu().numpy(), -9999)
        out = uparea.astype(np.float64 if area.dtype.kind == "f" else uparea.dtype)
        return out.reshape(self.shape)
