"""FlwdirRaster, ``from_array`` and ``from_dem``: the raster flow-direction
object: shape, mask, transform, coordinates, area, rank; upstream area and
accumulation; basins, sub-basins, their bounds and outlets, the interbasin
mask, inflow and outflow cells, stream order, stream distance, height above
the nearest drain, floodplains, D4 digging and nodata filling; paths and
snapping in metres; stream and flow-direction features; upscaling, unit
catchments and the sub-grid river statistics. Above 2^21 cells the accumulations, the
Strahler order (one tile-plan accumulation a level) and the downward sweeps
run through the tile plan (``ops/tile_plan.py``: ``accumulate`` upward,
``accumulate_down`` downward), below it through the single-chunk plans and
pointer doubling.
A tile plan that cannot be built (a coarse graph past the big router's 2^28
slots, more than one card holds) raises the build's ValueError: no method
leaves the card for another engine."""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import basins as basins_mod
from . import dem as dem_mod
from . import regions as regions_mod
from . import streams as streams_mod
from . import subgrid as subgrid_mod
from . import upscale as upscale_mod
from ._backend import resolve_device
from .codecs import FTYPES, infer_ftype
from .flwdir import Flwdir
from .gridtools import features as _features
from .ops import graph
from .ops.walk import paths as _paths
from .ops.walk import snap_walk
from .utils import geodesy
from .utils.affine import IDENTITY, Affine, array_bounds

__all__ = ["FlwdirRaster", "from_array", "from_dem"]

# from_dem's engine="auto" fills on the card from this many cells up; the
# host heap costs O(n log n) single-core time past this scale
_FROM_DEM_DEV_MIN = 1 << 21


def _from_dem_engine(device, size):
    """The fill ``engine="auto"`` takes: ``"device"`` on a CUDA device from
    ``_FROM_DEM_DEV_MIN`` cells up, else the host priority flood."""
    return "device" if device.type == "cuda" and size >= _FROM_DEM_DEV_MIN else "host"


def from_dem(
    data,
    nodata=-9999.0,
    max_depth=-1.0,
    transform=IDENTITY,
    latlon=False,
    outlets="edge",
    engine="auto",
    device=None,
):
    """Flow direction raster from a DEM by steepest gradient.

    ``engine="host"`` runs the exact priority-flood fill on the host
    (:func:`pyflwdir_torch.dem.fill_depressions`), which emits the D8
    directions. ``engine="device"`` fills on ``device``
    (:func:`pyflwdir_torch.ops.fill.fill_depressions_dev`, kernel F1 on the
    card) and derives D8 there (``d8_from_filled``): the same filled
    surface, cast to float32; directions may differ from the host's on ties
    and flats, both valid drainages of that surface. ``"auto"`` takes the
    device on CUDA from ``_FROM_DEM_DEV_MIN`` cells up, else the host.
    ``device`` also holds the graph; ``None`` means the card.
    """
    if engine not in ("auto", "host", "device"):
        raise ValueError(f"Unknown engine: {engine}")
    data = np.asarray(data)
    device = resolve_device(device)
    if engine == "auto":
        engine = _from_dem_engine(device, data.size)
    if engine == "device":
        from .ops.fill import d8_from_filled, fill_depressions_dev

        filled = fill_depressions_dev(
            data, nodata=nodata, outlets=outlets, max_depth=max_depth, device=device
        )
        d8 = d8_from_filled(filled, nodata=nodata).cpu().numpy()
    else:
        d8 = dem_mod.fill_depressions(
            data, nodata=nodata, max_depth=max_depth, outlets=outlets
        )[1]
    return from_array(
        d8, ftype="d8", check_ftype=False, transform=transform, latlon=latlon,
        device=device,
    )


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
        idxs_seq=None,
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
            idxs_seq=idxs_seq,
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

    @property
    def _dict(self):
        """The constructor's arguments (numpy arrays), as ``dump`` writes
        them."""
        return {
            "ftype": self.ftype,
            "shape": self.shape,
            "nnodes": self.nnodes,
            "transform": self.transform,
            "latlon": self.latlon,
            "idxs_ds": self.idxs_ds,
            "idxs_seq": self._seq,
            "idxs_pit": self._pit,
        }

    @property
    def ncells(self):
        """Number of valid cells."""
        return self.nnodes

    def add_pits(self, idxs=None, xy=None, streams=None):
        """Make the cells ``idxs`` (or at ``xy``) pits, first snapped
        downstream to the ``streams`` cells where given; every derived state
        is dropped."""
        Flwdir.add_pits(self, idxs=self._check_idxs_xy(idxs, xy, streams))

    def set_transform(self, transform, latlon=False):
        """Set the affine transform."""
        if not isinstance(transform, Affine):
            try:
                transform = Affine(*transform)
            except TypeError:
                raise ValueError("Invalid transform.")
        self.transform = transform
        self.latlon = bool(latlon)

    def to_array(self, ftype=None):
        """Dense flow-direction raster in ``ftype`` (the raster's own where
        None): (nrow, ncol) uint8 for d8 and ldd, (2, nrow, ncol) int32 for
        nextxy. Parity: pyflwdir.py:341-360."""
        if ftype is None:
            ftype = self.ftype
        if ftype not in FTYPES:
            raise ValueError(f'ftype "{ftype}" unknown')
        return FTYPES[ftype].to_array(self.idxs_ds, self.shape, mv=self._mv)

    def index(self, xs, ys, **kwargs):
        """Linear cell indices of x/y coordinates."""
        return geodesy.coords_to_idxs(xs, ys, self.transform, self.shape, **kwargs)

    def xy(self, idxs, **kwargs):
        """Cell-centre x/y coordinates of linear indices."""
        return geodesy.idxs_to_coords(idxs, self.transform, self.shape, **kwargs)

    @property
    def bounds(self):
        """The raster's ``[xmin, ymin, xmax, ymax]``."""
        return np.array(array_bounds(*self.shape, self.transform), dtype=np.float64)

    @property
    def extent(self):
        """The raster's ``[xmin, xmax, ymin, ymax]``."""
        xmin, ymin, xmax, ymax = self.bounds
        return np.array([xmin, xmax, ymin, ymax], dtype=np.float64)

    @property
    def distnc(self):
        """Distance to the outlet in metres (``stream_distance(unit="m")``,
        cached)."""
        if "distnc" in self._cached:
            return self._cached["distnc"]
        distnc = self.stream_distance(unit="m")
        if self.cache:
            self._cached["distnc"] = distnc
        return distnc

    ### LOCAL METHODS ###

    def _walk_args(self, idxs, xy, mask, max_length, unit, direction):
        unit = str(unit).lower()
        if unit not in ["m", "cell"]:
            raise ValueError(f'Unknown unit: {unit}, select from ["m", "cell"].')
        return dict(
            idxs0=self._check_idxs_xy(idxs, xy),
            idxs_nxt=self._nxt(direction),
            mask=self._check_data(mask, "mask", optional=True),
            max_length=max_length,
            real_length=unit == "m",
            ncol=self.shape[1],
            latlon=self.latlon,
            transform=self.transform,
        )

    def path(self, idxs=None, xy=None, mask=None, max_length=None, unit="cell",
             direction="down"):
        """The cells down- (or up the main upstream cells) from each of
        ``idxs`` (or ``xy``), to a pit, a headwater, a ``mask`` cell or
        ``max_length`` (cells or metres, ``unit``): (list of int64 paths,
        float64 lengths)."""
        return _paths(**self._walk_args(idxs, xy, mask, max_length, unit, direction))

    def snap(self, idxs=None, xy=None, mask=None, max_length=None, unit="cell",
             direction="down"):
        """The last cell of each :meth:`path` and its length: (int64 cells,
        float32 lengths)."""
        return snap_walk(**self._walk_args(idxs, xy, mask, max_length, unit, direction))

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
        """Build (once) and cache the hierarchical tile plan. A coarse graph
        past the routers' capacity raises the build's ValueError."""
        if "tile_plan" not in self._cached:
            from .ops.tile_plan import build_tile_plan

            self._cached["tile_plan"] = build_tile_plan(
                self._idxs_ds, self.shape, device=self.device
            )
        return self._cached["tile_plan"]

    def save_plans(self, path, down=True):
        """Write this raster's tile plan to the directory ``path``, so that a
        later process can :meth:`load_plans` it instead of building it; with
        ``down=True`` the downward indices (``stream_distance``, ``basins``,
        ``hand``, ``fillnodata(direction="up")`` of the uncut graph) too.
        Builds the plan first where it is not cached; a build that fails
        raises its ValueError. Returns the manifest."""
        return self._tile_plan().save(path, down=down)

    def load_plans(self, path, mmap=True):
        """Load a saved tile plan (the port's or the JAX package's
        ``save_plans`` directory) into this object's cache, on its device; a
        plan of another shape raises ValueError. Returns the plan."""
        from .ops.tile_plan import TilePlan

        tp = TilePlan.load(path, mmap=mmap, device=self.device)
        if tuple(tp.shape) != tuple(self.shape):
            raise ValueError(f"plan shape {tp.shape} does not match raster {self.shape}")
        self._cached["tile_plan"] = tp
        return tp

    def _accumulate_dev(self, data):
        """Flow accumulation through the cached tile plan above 2^21 cells,
        the 1-D engines (Flwdir._accumulate_dev) up to that."""
        if self.size <= self._TILE_PLAN_MIN:
            return super()._accumulate_dev(data)
        return self._tile_plan().accumulate(data)

    def stream_order(self, type="strahler", mask=None):
        """Strahler (default) or classic stream order (uint8). Above the
        tile-plan threshold a Strahler order of a D8 raster with no mask runs
        on the device through the cached tile plan
        (:func:`pyflwdir_torch.ops.order.strahler_tile_plan`, the D8 codes
        made on the device from the graph) and is cached; otherwise as
        :meth:`Flwdir.stream_order`."""
        if (
            str(type).lower() == "strahler"
            and mask is None
            and self.ftype == "d8"
            and self.size > self._TILE_PLAN_MIN
        ):
            if "strord" in self._cached:
                return self._cached["strord"].reshape(self.shape)
            from .ops.order import d8_codes, strahler_tile_plan

            codes = self._cached.get("d8_codes")
            if codes is None:  # kept, so the plan's cached grids stay keyed to it
                codes = d8_codes(self._ds, self.shape)
                if self.cache:
                    self._cached["d8_codes"] = codes
            strord = strahler_tile_plan(codes, self._tile_plan()).cpu().numpy()
            if self.cache:
                self._cached["strord"] = strord.ravel()
            return strord.reshape(self.shape)
        return super().stream_order(type=type, mask=mask)

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
        them); None up to the size threshold. A cut graph whose coarse level
        passes the routers' capacity raises the build's ValueError."""
        if self.size <= self._TILE_PLAN_MIN:
            return None
        if cut is None:
            return self._tile_plan()
        from .ops.tile_plan import build_tile_plan

        ar = np.arange(self.size, dtype=np.int64)
        ids2 = np.where(np.asarray(cut, bool) & self.mask, ar, self._idxs_ds)
        return build_tile_plan(ids2, self.shape, device=self.device)

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

    def basin_bounds(self, basins=None, **kwargs):
        """Bounding box of each basin (``basins`` derived with ``kwargs``
        where None): (labels, (k, 4) boxes, the total box); the extents
        reduced on the device."""
        return regions_mod.region_bounds(
            self._check_data(basins, "basins", flatten=False, **kwargs),
            transform=self.transform,
            device=self.device,
        )

    def basin_outlets(self, basins):
        """Outlet cells of each basin, on the device: (labels, int64
        cells)."""
        return regions_mod.region_outlets(self._check_data(basins, "basins"), self._ds)

    def subbasins_streamorder(self, strord=None, mask=None, min_sto=-2):
        """Sub-basins split where the stream order (derived where None)
        changes: (int32 label map, outlet indices numbered up- to
        downstream)."""
        mask = self._check_data(mask, "mask", optional=True)
        subbas, idxs_out = basins_mod.subbasins_streamorder(
            self._ds,
            self._check_data(strord, "strord"),
            self.rank.ravel(),
            mask=None if mask is None else torch.as_tensor(mask != 0, device=self.device),
            min_sto=min_sto,
        )
        return subbas.cpu().numpy().reshape(self.shape), idxs_out

    def subbasins_pfafstetter(self, depth=1, uparea=None, upa_min=0.0):
        """Pfafstetter sub-basins to ``depth`` digits over the cells whose
        ``uparea`` (in cells, derived where None) is at least ``upa_min``:
        (int32 label map, outlet indices)."""
        uparea = self._check_data(uparea, "uparea")
        mask = uparea >= upa_min if upa_min is not None else None
        subbas, idxs_out = basins_mod.subbasins_pfafstetter(
            self.idxs_pit,
            self._ds,
            torch.as_tensor(self.idxs_us_main, device=self.device),
            torch.as_tensor(uparea, device=self.device),
            self.rank.ravel(),
            mask=None if mask is None else torch.as_tensor(mask, device=self.device),
            depth=depth,
        )
        return subbas.cpu().numpy().reshape(self.shape), idxs_out

    def subbasins_area(self, area_min, uparea=None):
        """Sub-basins of at least ``area_min`` (``uparea`` in km2, derived
        where None): (uint32 label map, outlet indices)."""
        subbas, idxs_out = basins_mod.subbasins_area(
            self._idxs_ds,
            self.rank.ravel(),
            self.idxs_us_main,
            self._check_data(uparea, "uparea", unit="km2"),
            area_min,
            device=self.device,
        )
        return subbas.reshape(self.shape), idxs_out

    def interbasin_mask(self, region, stream=None):
        """The most downstream contiguous area within ``region``, and, with
        ``stream``, of the basins that hold a ``stream`` cell."""
        stream = self._check_data(stream, "stream", optional=True)
        mask = basins_mod.interbasin_mask(
            self._ds,
            torch.as_tensor(self._check_data(region, "region") != 0, device=self.device),
            stream=None if stream is None else torch.as_tensor(stream != 0, device=self.device),
        )
        return mask.cpu().numpy().reshape(self.shape)

    def inflow_idxs(self, region):
        """The most upstream cells that flow into ``region`` from outside."""
        region = torch.as_tensor(self._check_data(region, "region") != 0, device=self.device)
        ds = self._ds
        ar = torch.arange(self.size, dtype=ds.dtype, device=self.device)
        dsl = graph.self_loop(ds)
        cand = (ds >= 0) & ~region & region[dsl] & (dsl != ar)
        cnt = graph.accumulate(ds, cand.to(torch.int32), tree=self._tree)
        return np.flatnonzero((cand & (cnt == 1)).cpu().numpy()).astype(self._idxs_ds.dtype)

    def outflow_idxs(self, region):
        """The most downstream cells of ``region``: cells of the region that
        leave it (a pit or a step out) with no such cell below them."""
        region = torch.as_tensor(self._check_data(region, "region") != 0, device=self.device)
        ds = self._ds
        ar = torch.arange(self.size, dtype=ds.dtype, device=self.device)
        dsl = graph.self_loop(ds)
        crossing = (ds >= 0) & region & ((dsl == ar) | ~region[dsl])
        cross = crossing.to(torch.int32)
        below = graph.path_sum(ds, cross) - cross + cross[graph.reach(ds, None)]
        return np.flatnonzero((crossing & (below == 0)).cpu().numpy()).astype(
            self._idxs_ds.dtype)

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

    ### FEATURES ###

    def vectorize(self, mask=None, xs=None, ys=None, direction="down", **kwargs):
        """One two-cell LineString feature a valid cell (inside ``mask``):
        the cell and its downstream (or main upstream) cell."""
        nxt = self._nxt(direction)
        mask = self._check_data(mask, "mask", optional=True)
        valid = nxt != self._mv
        if mask is not None:
            valid &= mask != 0
        w = np.flatnonzero(valid)
        return self.geofeatures(np.stack([w, nxt[w]], axis=1), xs=xs, ys=ys, **kwargs)

    def streams(self, mask=None, min_sto=1, xs=None, ys=None, idxs_out=None, max_len=0,
                direction="up", **kwargs):
        """Stream segments as LineString features, over the ``mask`` cells
        or those of stream order ``min_sto`` and above: confluence to
        confluence, or, with ``idxs_out``, between those outlet pixels along
        the main upstream (``direction="up"``) or downstream cells
        (:func:`subgrid.segment_indices`); ``kwargs`` maps are sampled at
        each segment's head."""
        if mask is not None:
            mask = self._check_data(mask, "mask")
        elif min_sto > 1:
            strord = self._check_data(kwargs.get("strord"), "strord")
            mask = strord >= min_sto
            kwargs.update(strord=strord)
        if idxs_out is not None:
            idxs = subgrid_mod.segment_indices(
                idxs_out=np.asarray(idxs_out).ravel(),
                idxs_nxt=self.idxs_us_main if direction == "up" else self.idxs_ds,
                mask=mask,
                max_len=max_len,
            )
            if direction == "up":
                idxs = [idxs0[::-1] for idxs0 in idxs]
            return self.geofeatures(idxs, xs=xs, ys=ys, **kwargs)
        mask_dev = None if mask is None else torch.as_tensor(mask != 0, device=self.device)
        nup = graph.upstream_count(self._ds, mask=mask_dev).cpu().numpy()
        idxs = streams_mod.streams(
            self._idxs_ds,
            self.rank.ravel(),
            nup,
            mask=None if mask is None else np.asarray(mask) != 0,
            max_len=max_len,
        )
        return self.geofeatures(idxs, xs=xs, ys=ys, **kwargs)

    def geofeatures(self, flowpaths, xs=None, ys=None, **kwargs):
        """LineString features of ``flowpaths`` (:func:`gridtools.features`)."""
        return _features(
            flowpaths=flowpaths,
            xs=self._check_data(xs, "xs", optional=True),
            ys=self._check_data(ys, "ys", optional=True),
            transform=self.transform,
            shape=self.shape,
            **kwargs,
        )

    ### UPSCALE ###

    def upscale(self, scale_factor, method="ihu", uparea=None, **kwargs):
        """The flow directions upscaled by ``scale_factor``: IHU (default),
        EAM+, EAM or DMM (:mod:`upscale`; ``"com"`` / ``"com2"`` are the old
        names of EAM+ / IHU and warn), with ``uparea`` in cells derived where
        None. Returns (the lowres FlwdirRaster on this raster's device, its
        transform scaled; the outlet pixel of each lowres cell)."""
        if self.ftype not in ["d8", "ldd"]:
            raise ValueError("The upscale method only works for D8 or LDD flow directon data.")
        methods = ["ihu", "eam_plus", "com2", "com", "eam", "dmm"]
        method = str(method).lower()
        if method not in methods:
            methodstr = "', '".join(methods)
            raise ValueError(f"Unknown method: {method}, select from: '{methodstr}'")
        if "com" in method:
            method_new = {"com": "eam_plus", "com2": "ihu"}.get(method)
            warnings.warn(f"{method} renamed to {method_new}.", DeprecationWarning)
            method = method_new
        idxs_ds1, idxs_out, shape1 = getattr(upscale_mod, method)(
            subidxs_ds=self._idxs_ds,
            subuparea=self._check_data(uparea, "uparea"),
            subshape=self.shape,
            cellsize=scale_factor,
            device=self.device,
            **kwargs,
        )
        a, b, c, d, e, f = self.transform
        flw1 = FlwdirRaster(
            idxs_ds=idxs_ds1,
            shape=shape1,
            transform=Affine(a * scale_factor, b, c, d, e * scale_factor, f),
            ftype=self.ftype,
            latlon=self.latlon,
            device=self.device,
        )
        if not flw1.isvalid:
            raise ValueError(
                "The upscaled flow direction network is invalid. "
                "Please provide a minimal reproducible example."
            )
        return flw1, idxs_out.reshape(shape1)

    def upscale_error(self, other, idxs_out):
        """Validity of the upscaled raster ``other`` with its outlet pixels
        ``idxs_out`` (:func:`upscale.upscale_error`): uint8 in ``other``'s
        shape, 1 ok, 0 error, 255 missing."""
        if self._mv != other._mv:
            raise ValueError("the two rasters use another missing value")
        flwerr = upscale_mod.upscale_error(
            other._check_data(idxs_out, "idxs_out"), other._idxs_ds, self._idxs_ds)[0]
        return flwerr.reshape(other.shape)

    ### UNIT CATCHMENTS ###

    def ucat_outlets(self, cellsize, uparea=None, method="eam_plus"):
        """The unit-catchment outlet pixel of each lowres cell of
        ``cellsize`` (:func:`subgrid.outlets`, ``uparea`` in cells derived
        where None), in the lowres shape."""
        methods = ["eam_plus", "dmm"]
        method = str(method).lower()
        if method not in methods:
            methodstr = "', '".join(methods)
            raise ValueError(f"Unknown method: {method}, select from: '{methodstr}'")
        idxs_out, shape1 = subgrid_mod.outlets(
            idxs_ds=self._ds,
            uparea=self._check_data(uparea, "uparea"),
            cellsize=int(cellsize),
            shape=self.shape,
            method=method,
            device=self.device,
        )
        return idxs_out.reshape(shape1)

    def ucat_area(self, idxs_out, unit="cell"):
        """Unit-catchment map and the area of each catchment of
        ``idxs_out`` (:func:`subgrid.ucat_area`, on the device): int32 in
        cells, float64 in an area unit, -9999 at missing outlets."""
        unit = str(unit).lower()
        if unit not in geodesy.AREA_FACTORS:
            fstr = '", "'.join(geodesy.AREA_FACTORS.keys())
            raise ValueError(f'Unknown unit: {unit}, select from "{fstr}".')
        if unit == "cell":
            area = np.ones(self.size, dtype=np.int32)
        else:
            area = np.asarray(self.area).ravel() / geodesy.AREA_FACTORS[unit]
        ucat_map, ucat_are = subgrid_mod.ucat_area(
            idxs_out=np.asarray(idxs_out).ravel(),
            idxs_ds=self._ds,
            area=area,
            device=self.device,
        )
        return (ucat_map.cpu().numpy().reshape(self.shape),
                ucat_are.cpu().numpy().reshape(np.asarray(idxs_out).shape))

    def ucat_volume(self, idxs_out, hand, depths=np.arange(0.5, 3.0, 0.5, dtype=np.float32)):
        """Unit-catchment map and flood volume [m3] of each catchment at
        each of ``depths`` above the ``hand`` surface
        (:func:`subgrid.ucat_volume`, on the device): (len(depths), *lowres
        shape) float32 sums in ``depths``' dtype."""
        ucat_map, ucat_vol = subgrid_mod.ucat_volume(
            idxs_out=np.asarray(idxs_out).ravel(),
            idxs_ds=self._ds,
            hand=self._check_data(hand, "hand"),
            area=np.asarray(self.area).ravel(),
            depths=depths,
            device=self.device,
        )
        return (ucat_map.cpu().numpy().reshape(self.shape),
                ucat_vol.cpu().numpy().reshape((len(depths), *np.asarray(idxs_out).shape)))

    def _subgrid_args(self, idxs_out, direction, directions=("up", "down")):
        direction = str(direction).lower()
        if direction not in directions:
            raise ValueError(
                f"Unknown flow direction: {direction}, select from {list(directions)}.")
        if idxs_out is None:
            idxs_out = np.arange(self.size, dtype=np.intp).reshape(self.shape)
        return np.asarray(idxs_out), direction

    def subgrid_rivlen(self, idxs_out, mask=None, direction="up", unit="cell"):
        """Sub-grid river length from each outlet pixel to the next one up
        the main stream or downstream (:func:`subgrid.segment_length`), in
        cells or metres."""
        idxs_out, direction = self._subgrid_args(idxs_out, direction)
        if unit not in ["m", "cell"]:
            raise ValueError(f'Unknown unit: {unit}, select from ["m", "cell"]')
        distnc = self.distnc if unit == "m" else self.stream_distance(unit=unit)
        rivlen = subgrid_mod.segment_length(
            idxs_out=idxs_out.ravel(),
            idxs_nxt=self._nxt(direction),
            mask=self._check_data(mask, "mask", optional=True),
            distnc=np.asarray(distnc).ravel(),
        )
        return rivlen.reshape(idxs_out.shape)

    def subgrid_rivslp(self, idxs_out, elevtn, length=1000, direction="both", method="mean",
                       mask=None):
        """Sub-grid river slope: over a main-stem window of ``length``
        metres centred on each outlet pixel (``direction="both"``,
        :func:`subgrid.fixed_length_slope`), else over the segment up or
        down (:func:`subgrid.segment_slope`); least squares where
        ``method="lstsq"``, else between the ends."""
        idxs_out, direction = self._subgrid_args(idxs_out, direction, ("both", "up", "down"))
        elevtn = self._check_data(elevtn, "elevtn")
        mask = self._check_data(mask, "mask", optional=True)
        distnc = np.asarray(self.distnc).ravel()
        if direction == "both":
            rivslp = subgrid_mod.fixed_length_slope(
                idxs_out=idxs_out.ravel(),
                idxs_ds=self._idxs_ds,
                idxs_us_main=self.idxs_us_main,
                elevtn=elevtn,
                distnc=distnc,
                length=length,
                mask=mask,
                lstsq=method == "lstsq",
            )
        else:
            rivslp = subgrid_mod.segment_slope(
                idxs_out=idxs_out.ravel(),
                idxs_nxt=self._nxt(direction),
                elevtn=elevtn,
                distnc=distnc,
                mask=mask,
                lstsq=method == "lstsq",
            )
        return rivslp.reshape(idxs_out.shape)

    def _subgrid_stat(self, fn, idxs_out, data, weights, nodata, mask, direction):
        idxs_out, direction = self._subgrid_args(idxs_out, direction)
        if weights is None:
            weights = np.ones(self.size, dtype=np.float32)
        out = fn(
            idxs_out=idxs_out.ravel(),
            idxs_nxt=self._nxt(direction),
            data=self._check_data(data, "data"),
            weights=np.asarray(weights).ravel(),
            nodata=nodata,
            mask=self._check_data(mask, "mask", optional=True),
        )
        return out.reshape(idxs_out.shape)

    def subgrid_rivavg(self, idxs_out, data, weights=None, nodata=-9999.0, mask=None,
                       direction="up"):
        """Weighted mean of ``data`` over each sub-grid river segment
        (:func:`subgrid.segment_average`)."""
        return self._subgrid_stat(subgrid_mod.segment_average, idxs_out, data, weights, nodata,
                                  mask, direction)

    def subgrid_rivmed(self, idxs_out, data, weights=None, nodata=-9999.0, mask=None,
                       direction="up"):
        """Median of ``data`` over each sub-grid river segment
        (:func:`subgrid.segment_median`)."""
        return self._subgrid_stat(subgrid_mod.segment_median, idxs_out, data, weights, nodata,
                                  mask, direction)

    ### ELEVATION ###

    def dem_dig_d4(self, elevtn, rivmsk=None, nodata=-9999.0):
        """Elevation with a D4-connected channel dug along every diagonal
        link (:func:`dem.dig_4connectivity`, native, on the host), in
        ``elevtn``'s dtype."""
        elv_out = dem_mod.dig_4connectivity(
            self._idxs_ds,
            self.rank.ravel(),
            self._check_data(elevtn, "elevtn"),
            shape=self.shape,
            mask=self._check_data(rivmsk, "rivmsk", optional=True),
            nodata=nodata,
        )
        return elv_out.reshape(self.shape).astype(np.asarray(elevtn).dtype)

    def floodplains(self, elevtn, uparea=None, upa_min=1000, b=0.3):
        """Geomorphic floodplains (:func:`dem.floodplains`, on the device),
        ``uparea`` in km2 derived where None: int8, 1 floodplain or stream,
        0 not, -1 missing."""
        dev = self.device
        fldpln = dem_mod.floodplains(
            self._ds,
            torch.as_tensor(self._check_data(elevtn, "elevtn"), device=dev),
            torch.as_tensor(self._check_data(uparea, "uparea", unit="km2"), device=dev),
            upa_min=upa_min,
            b=b,
        )
        return fldpln.cpu().numpy().reshape(self.shape)

    ### SHORTCUTS ###

    def _check_data(self, data, name, optional=False, flatten=True, **kwargs):
        """:meth:`Flwdir._check_data`, which also derives a None ``basins``
        (:meth:`basins` with ``kwargs``)."""
        if data is None and name == "basins" and not optional:
            data = self.basins(**kwargs)
        return super()._check_data(data, name, optional, flatten=flatten, **kwargs)

    def _check_idxs_xy(self, idxs=None, xy=None, streams=None):
        if (xy is not None and idxs is not None) or (xy is None and idxs is None):
            raise ValueError("Either idxs or xy should be provided.")
        elif xy is not None:
            idxs = self.index(*xy)
        return Flwdir._check_idxs_xy(self, idxs, streams)
