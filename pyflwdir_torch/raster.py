"""FlwdirRaster and ``from_array``: the raster flow-direction object, the
subset ported so far: shape, mask, transform, area, rank; upstream area and
accumulation; basins, stream distance, height above the nearest drain and
nodata filling from downstream. Above 2^21 cells these run through the tile
plan (``ops/tile_plan.py``: ``accumulate`` upward, ``accumulate_down``
downward), below it through the single-chunk plans and pointer doubling."""

from __future__ import annotations

import numpy as np
import torch

from . import basins as basins_mod
from . import dem as dem_mod
from . import streams as streams_mod
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

    def index(self, xs, ys, **kwargs):
        """Linear cell indices of x/y coordinates."""
        return geodesy.coords_to_idxs(xs, ys, self.transform, self.shape, **kwargs)

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

    ### DOWNWARD SWEEPS ###

    def _tp_down(self, cut=None):
        """Tile plan for the downward-path operations
        (``TilePlan.accumulate_down``), optionally of the graph cut at the
        ``cut`` cells (made pits, so they are outlets for all upstream of
        them); None up to the size threshold. Where the JAX package falls
        back to a host sweep on a failed build this raises
        NotImplementedError."""
        if self.size <= self._TILE_PLAN_MIN:
            return None
        if cut is None:
            return self._tile_plan()
        from .ops.tile_plan import build_tile_plan

        ar = np.arange(self.size, dtype=np.int64)
        ids2 = np.where(np.asarray(cut, bool) & self.mask, ar, self._idxs_ds)
        try:
            return build_tile_plan(ids2, self.shape, device=self.device)
        except ValueError as e:
            raise NotImplementedError(
                f"cut-graph tile plan build failed ({e}); the host-sweep fallback of "
                "the JAX package is queued for a later slice of the PyTorch port"
            ) from e

    def _down_np(self, tp, w):
        """``tp.accumulate_down`` of a host array, back on the host."""
        return tp.accumulate_down(torch.as_tensor(w, device=self.device)).cpu().numpy()

    def basins(self, idxs=None, xy=None, ids=None, **kwargs):
        """(Sub)basin map with unique ids: the cells draining to each outlet
        (the pits unless ``idxs`` or ``xy`` name others), 0 elsewhere."""
        if idxs is None and xy is None:
            idxs = self.idxs_pit
        else:
            idxs = self._check_idxs_xy(idxs, xy, **kwargs)
        idxs = np.asarray(idxs)
        if ids is not None:
            ids = np.atleast_1d(ids).ravel()
            if ids.size != idxs.size:
                raise ValueError("IDs size does not match size of idxs.")
            elif np.any(ids == 0):
                raise ValueError("IDs cannot contain a value zero.")
        ids_np = np.arange(1, idxs.size + 1, dtype=np.uint32) if ids is None else ids
        # an id of 2^31 or more does not fit the exact int32 downward sweep
        if self.size > self._TILE_PLAN_MIN and not (
            ids_np.size and int(ids_np.max()) >= 2**31
        ):
            # root-id broadcast over the graph cut at the outlets
            cut = np.zeros(self.size, dtype=bool)
            cut[idxs] = True
            w = np.zeros(self.size, np.int32)
            w[idxs] = ids_np.astype(np.int32)
            out = self._down_np(self._tp_down(cut=cut), w)
            return np.where(self.mask, out, 0).astype(ids_np.dtype).reshape(self.shape)
        return basins_mod.basins(self._ds, idxs, ids=ids).reshape(self.shape)

    def stream_distance(self, mask=None, unit="cell"):
        """Distance to the outlet, or to the next downstream cell of
        ``mask``: int32 cells or float32 metres, -9999 at missing cells.
        Above the tile-plan threshold one ``accumulate_down`` of the step
        lengths, with the mask cells cut into pits."""
        unit = str(unit).lower()
        if unit not in ["m", "cell"]:
            raise ValueError(f'Unknown unit: {unit}, select from "m", "cell"')
        mask = self._check_data(mask, "mask", optional=True)
        cutm = None if mask is None else (mask != 0)
        tp = self._tp_down(cut=cutm)
        if tp is None:
            dist = streams_mod.stream_distance(
                self._ds,
                self.shape,
                mask=None if cutm is None else torch.as_tensor(cutm, device=self.device),
                real_length=unit != "cell",
                latlon=self.latlon,
                transform=self.transform,
            )
            return dist.cpu().numpy().reshape(self.shape)
        ar = np.arange(self.size, dtype=np.int64)
        valid = self.mask
        ids2 = self._idxs_ds
        if cutm is not None:
            ids2 = np.where(cutm & valid, ar, ids2)
        moving = (ids2 >= 0) & (ids2 != ar)
        if unit == "cell":
            out = self._down_np(tp, moving.astype(np.int32))
            dist = np.where(valid, out, -9999).astype(np.int32)
        else:
            w = np.asarray(
                geodesy.distance_grid(
                    ids2, self.shape, latlon=self.latlon, transform=self.transform
                ),
                np.float32,
            ).ravel()
            out = self._down_np(tp, np.where(moving, w, 0).astype(np.float32))
            dist = np.where(valid, out, -9999.0).astype(np.float32)
        return dist.reshape(self.shape)

    def fillnodata(self, data, nodata, direction="down", how="max"):
        """Fill nodata cells from the nearest valid value up- or downstream.
        Above the tile-plan threshold ``direction="up"`` (the first valid
        value downstream) is a root broadcast over the graph cut at the
        valid cells: two ``accumulate_down`` sweeps. Integers stay exact;
        floats ride float32 there."""
        if str(direction).lower() != "up" or self.size <= self._TILE_PLAN_MIN:
            return super().fillnodata(data, nodata, direction=direction, how=how)
        dflat = self._check_data(data, "data")
        if dflat.dtype.kind in "iu":
            lo = int(dflat.min(initial=0))
            hi = int(dflat.max(initial=0))
            if -(2**31) <= lo and hi < 2**31:
                wdt = np.int32
            elif -(2**63) <= lo and hi < 2**63:
                wdt = np.int64
            else:  # values the sweep cannot hold exactly
                return super().fillnodata(data, nodata, direction=direction, how=how)
        else:
            wdt = np.float32
        has = dflat != nodata
        valid = self.mask
        tp = self._tp_down(cut=has & valid)
        seeded = has & valid  # the cut roots that carry a value
        a = self._down_np(tp, np.where(seeded, dflat.astype(wdt), 0).astype(wdt))
        ok = self._down_np(tp, seeded.astype(np.int32)) > 0
        out = np.where(valid & ~has & ok, a, dflat).astype(np.asarray(data).dtype)
        return out.reshape(np.asarray(data).shape)

    def hand(self, drain, elevtn):
        """Height above the nearest drain: 0 at drain cells, -9999 at missing
        cells. Above the tile-plan threshold the graph is cut at the drain
        cells and each cut root's elevation is broadcast over its tree by one
        ``accumulate_down``; elevations ride float32 there and the result is
        float64."""
        drain_arr = self._check_data(drain, "drain")
        elev_arr = self._check_data(elevtn, "elevtn")
        dr = drain_arr != 0
        valid = self.mask
        tp = self._tp_down(cut=dr)
        if tp is None:
            hand = dem_mod.height_above_nearest_drain(
                self._ds,
                torch.as_tensor(drain_arr, device=self.device),
                torch.as_tensor(elev_arr, device=self.device),
            )
            return hand.cpu().numpy().reshape(self.shape)
        ar = np.arange(self.size, dtype=np.int64)
        z = np.asarray(elev_arr, np.float32)
        is_root = (dr | (self._idxs_ds == ar)) & valid
        zroot = self._down_np(tp, np.where(is_root, z, 0).astype(np.float32))
        hand = np.where(valid, z - zroot, -9999.0)
        hand = np.where(dr & valid, 0.0, hand)
        return hand.reshape(self.shape).astype(np.float64)

    ### SHORTCUTS ###

    def _check_idxs_xy(self, idxs=None, xy=None, streams=None):
        if (xy is not None and idxs is not None) or (xy is None and idxs is None):
            raise ValueError("Either idxs or xy should be provided.")
        elif xy is not None:
            idxs = self.index(*xy)
        return Flwdir._check_idxs_xy(self, idxs, streams)
