"""Flwdir: the graph-only flow-direction object.

Same constructor contract and accumulation dispatch as the JAX package's
``Flwdir``; inputs and outputs are numpy arrays, and the graph, its plans
and the accumulation run on the object's ``device`` (CUDA unless the
caller asks for the CPU). ``idxs_ds`` and every index set it returns are
int64. The Strahler order runs in the native host library over the DFS
plan's preorder, as in the JAX package; the classic order, the main
upstream cells, the nodata accumulations, the moving windows, the
upstream sums and the estuary classification run on the device; paths and
snapping walk in the native host library, and the elevation adjustment and
the river depths run on the host, as in the JAX package.
"""

from __future__ import annotations

import pickle
import pprint

import numpy as np
import torch

from . import arithmetics, dem, rivers, runtime, streams, trace
from ._backend import resolve_device
from .ops import graph
from .ops.walk import paths as _paths
from .ops.walk import snap_walk

__all__ = ["Flwdir", "from_dataframe"]


def get_loc_idx(idxs, idxs_ds):
    """Local indices of the node ids ``idxs_ds`` among the ids ``idxs``; a
    downstream id not among them makes the node a pit."""
    idxs = np.asarray(idxs)
    idxs_ds = np.asarray(idxs_ds)
    sorter = np.argsort(idxs, kind="stable")
    pos = np.minimum(np.searchsorted(idxs[sorter], idxs_ds, sorter=sorter), idxs.size - 1)
    found = idxs[sorter[pos]] == idxs_ds
    return np.where(found, sorter[pos], np.arange(idxs.size)).astype(idxs.dtype)


def from_dataframe(df, ds_col="idx_ds", device=None):
    """A Flwdir of the rows of ``df``: its index the node ids, the column
    ``ds_col`` their downstream ids. ``device`` None means the card."""
    with trace.span("parse"):
        return Flwdir(idxs_ds=get_loc_idx(idxs=df.index.values, idxs_ds=df[ds_col].values),
                      device=device)


class Flwdir:
    """Flow direction parsed to general actionable format.

    ``idxs_ds[i] == i`` marks a pit, a negative value a missing cell.
    """

    def __init__(
        self,
        idxs_ds,
        area=None,
        idxs_pit=None,
        idxs_outlet=None,
        idxs_seq=None,
        nnodes=None,
        cache=True,
        device=None,
    ):
        idxs_ds = np.asarray(idxs_ds)
        self.size = idxs_ds.size
        if self.size <= 1:
            raise ValueError(f"Invalid FlwdirRaster: size {self.size}")
        self.shape = self.size
        # normalize missing values to -1 (the upstream library uses
        # dtype-specific sentinels: -1 / uint32-max / uint64-max)
        if idxs_ds.dtype.kind == "u":
            mv = np.iinfo(idxs_ds.dtype).max
            idxs_ds = np.where(idxs_ds == mv, -1, idxs_ds.astype(np.int64))
        self._idxs_ds = idxs_ds.astype(np.int64)
        self._mv = -1
        self._pit = None if idxs_pit is None else np.asarray(idxs_pit, np.int64)
        self.idxs_outlet = idxs_outlet
        self._seq = idxs_seq
        self._nnodes = nnodes
        self.device = resolve_device(device)
        self.cache = cache
        self._cached = dict()
        if area is not None:
            self._cached.update(area=area)
        if self.idxs_pit.size == 0:
            raise ValueError("Invalid FlwdirRaster: no pits found")

    ### REPRESENTATION ###

    def __str__(self):
        return pprint.pformat(self._dict)

    def __getitem__(self, idx):
        return self.idxs_ds[idx]

    ### INTERNAL DEVICE STATE ###

    @property
    def _ds(self):
        """Device copy of idxs_ds (int64)."""
        if "ds" not in self._cached:
            self._cached["ds"] = torch.as_tensor(self._idxs_ds, device=self.device)
        return self._cached["ds"]

    @property
    def _plan(self):
        """Cached DFS-interval accumulation plan (ops.plan.DfsPlan)."""
        if "plan" not in self._cached:
            from .ops.plan import build_plan

            self._cached["plan"] = build_plan(self._idxs_ds, device=self.device)
        return self._cached["plan"]

    @property
    def _tree(self):
        """Device mask of the cells that reach a pit (not missing, not on or
        above a cycle)."""
        if "tree" not in self._cached:
            self._cached["tree"] = torch.as_tensor(self.rank.ravel() >= 0, device=self.device)
        return self._cached["tree"]

    def _accel(self):
        """Cached router plan (ops.accel.build_accel_plan): the single-chunk
        ``AccelPlan``, the large-graph ``BigAccelPlan``, or None past both."""
        if "accel" not in self._cached:
            from .ops.accel import build_accel_plan

            self._cached["accel"] = build_accel_plan(
                self._idxs_ds, self._plan, device=self.device
            )
        return self._cached["accel"]

    def _accumulate_dev(self, data):
        """Flow accumulation of a device tensor, dispatched as the JAX
        package does: on a graph that fits the single-chunk ``AccelPlan``
        (float32 sums, kernels H1-H3), integer data whose total may reach
        2^24 takes the exact int64 DFS plan, other integer data the router
        plan and float data the float64 DFS plan; a ``BigAccelPlan`` takes
        integer and float data alike (int32, int64 or float64 sums); with no
        router plan, the DFS plan."""
        from .ops.accel_big import BigAccelPlan
        from .ops.plan import accumulate_planned, accumulate_planned_fast

        aplan = self._accel()
        if isinstance(aplan, BigAccelPlan):
            return aplan.accumulate(data)
        is_int = not data.dtype.is_floating_point
        # the single-chunk plan sums in float32: exact for integer totals below 2^24
        if is_int and data.numel() and data.dtype != torch.bool:
            # one read, no int64 copy
            lo, hi = trace.host_ints("accumulate_dev", *torch.aminmax(data))
            amax = max(-lo, hi)
            if amax * data.numel() >= 1 << 24:
                return accumulate_planned(self._plan, data)
        if aplan is not None and is_int:
            return aplan.accumulate(data)
        return accumulate_planned_fast(self._plan, data)

    def _invalidate(self):
        """Drop every derived state of the graph after ``idxs_ds`` changed:
        the device copy, the plans (built or loaded), rank, tree, orders and
        main upstream cells, and the cell order, pits and node count."""
        self._cached.clear()
        self._seq = None
        self._nnodes = None
        self._pit = None

    ### PROPERTIES ###

    @property
    def _dict(self):
        """The constructor's arguments (numpy arrays), as ``dump`` writes
        them."""
        return {
            "nnodes": self.nnodes,
            "idxs_ds": self.idxs_ds,
            "idxs_seq": self._seq,
            "idxs_pit": self._pit,
        }

    @property
    def idxs_ds(self):
        """Linear indices of downstream cell (int64)."""
        return self._idxs_ds

    @property
    def idxs_us_main(self):
        """Linear indices of the main upstream cell (the largest upstream
        area), -1 at headwaters."""
        if "idxs_us_main" in self._cached:
            return self._cached["idxs_us_main"]
        return self.main_upstream()

    @property
    def idxs_seq(self):
        """The cells that reach a pit, downstream cells first (int64)."""
        if self._seq is None:
            self.order_cells(method="sort")
        return self._seq

    @property
    def idxs_pit(self):
        """Linear indices of pits/outlets."""
        if self._pit is None:
            ids = self._idxs_ds
            self._pit = np.where(ids == np.arange(ids.size))[0].astype(np.int64)
        return self._pit

    @property
    def nnodes(self):
        """Number of valid cells."""
        if self._nnodes is None:
            self._nnodes = int(np.sum(self.rank >= 0))
        return self._nnodes

    @property
    def rank(self):
        """Distance to the outlet in cells; -1 on loops, -9999 missing."""
        if "rank" in self._cached:
            return self._cached["rank"]
        rank = graph.rank(self._ds).cpu().numpy().reshape(self.shape)
        if self.cache:
            self._cached["rank"] = rank
        return rank

    @property
    def isvalid(self):
        """True when no cell is on or drains into a cycle (rank computed
        anew)."""
        self._cached.pop("rank", None)
        return bool(np.all(self.rank != -1))

    @property
    def mask(self):
        """Boolean array of valid cells."""
        return self.idxs_ds != self._mv

    @property
    def distnc(self):
        """Distance to the outlet: unit steps (float32) on a graph object."""
        if "distnc" in self._cached:
            return self._cached["distnc"]
        return np.ones(self.size, dtype=np.float32)

    @property
    def area(self):
        """Cell area: the ``area`` given to the constructor, else unit areas."""
        if "area" in self._cached:
            return self._cached["area"]
        return np.ones(self.size, dtype=np.float32)

    @property
    def n_upstream(self):
        """Number of upstream cells of each cell (int8), -9 at missing cells."""
        return graph.upstream_count(self._ds).cpu().numpy().reshape(self.shape)

    ### SET/MODIFY PROPERTIES ###

    def order_cells(self, method="sort"):
        """Order the cells that reach a pit from down- to upstream: a stable
        sort of the device rank (both ``"sort"`` and ``"walk"``, either a
        valid order), kept as :attr:`idxs_seq`."""
        if method not in ("sort", "walk"):
            raise ValueError(f'Invalid method {method}, select from ["walk", "sort"]')
        self._seq = graph.idxs_seq(self._ds)
        self._nnodes = int(self._seq.size)

    def add_pits(self, idxs=None, streams=None):
        """Make the cells ``idxs`` pits, first snapped downstream to the
        ``streams`` cells where given; every derived state is dropped."""
        idxs1 = self._check_idxs_xy(idxs, streams=streams)
        self._idxs_ds[idxs1] = idxs1
        pits = np.unique(np.concatenate([self.idxs_pit, idxs1]))
        self._invalidate()
        self._pit = pits

    def repair_loops(self):
        """Make a pit of every cell on or above a cycle."""
        repair_idx = np.flatnonzero(self.rank.ravel() == -1)
        if repair_idx.size > 0:
            self.add_pits(repair_idx)

    def main_upstream(self, uparea=None):
        """The main upstream cell of each cell by ``uparea`` (derived where
        None), -1 at headwaters; of equal areas the lowest index. Cached as
        ``idxs_us_main``."""
        upa = torch.as_tensor(self._check_data(uparea, "uparea"), device=self.device)
        idxs_us_main = graph.main_upstream(self._ds, upa).cpu().numpy()
        if self.cache:
            self._cached["idxs_us_main"] = idxs_us_main
        return idxs_us_main

    ### IO ###

    def dump(self, fn):
        """Pickle the constructor's arguments (numpy arrays) to ``fn``."""
        with open(fn, "wb") as handle:
            pickle.dump(self._dict, handle, protocol=-1)

    @classmethod
    def load(cls, fn, device=None):
        """An object of this class from a :meth:`dump` file, on ``device``
        (None: the card). The file is unpickled: load only files this
        package wrote."""
        with open(fn, "rb") as handle:
            kwargs = pickle.load(handle)
        return cls(**kwargs, device=device)

    ### LOCAL METHODS ###

    def _nxt(self, direction):
        direction = str(direction).lower()
        if direction not in ["up", "down"]:
            raise ValueError(
                f'Unknown flow direction: {direction}, select from ["up", "down"].'
            )
        return self.idxs_ds if direction == "down" else self.idxs_us_main

    def path(self, idxs=None, mask=None, max_length=None, direction="down"):
        """The cells down- (or up the main upstream cells) from each of
        ``idxs``, to a pit, a headwater, a ``mask`` cell or ``max_length``
        steps: (list of int64 paths, float64 step counts)."""
        return _paths(
            idxs,
            self._nxt(direction),
            mask=self._check_data(mask, "mask", optional=True),
            max_length=max_length,
        )

    def snap(self, idxs=None, mask=None, max_length=None, direction="down", **kwargs):
        """The last cell of each :meth:`path` and its length: (int64 cells,
        float32 step counts). Other keywords (``unit=``, ...) are taken and
        ignored, as in the JAX package."""
        return snap_walk(
            idxs,
            self._nxt(direction),
            mask=self._check_data(mask, "mask", optional=True),
            max_length=max_length,
        )

    ### GLOBAL ARITHMETICS ###

    def downstream(self, data):
        """Each cell's downstream value; missing cells keep their own."""
        dflat = self._check_data(data, "data")
        out = dflat.copy()
        m = self.mask
        out[m] = dflat[self.idxs_ds[m]]
        return out.reshape(np.asarray(data).shape)

    def upstream_sum(self, data, mv=-9999):
        """Sum of the direct upstream values, on the device: ``mv`` where the
        cell's own or downstream value is ``mv``."""
        out = arithmetics.upstream_sum(
            self._ds, torch.as_tensor(self._check_data(data, "data"), device=self.device),
            nodata=mv,
        )
        return out.cpu().numpy().reshape(np.asarray(data).shape)

    def _window_args(self, strord, restrict_strord):
        strord = self._check_data(strord, "strord", optional=not restrict_strord)
        return dict(
            idxs_ds=self._ds,
            idxs_us_main=torch.as_tensor(self.idxs_us_main, device=self.device),
            strord=None if strord is None else torch.as_tensor(strord, device=self.device),
        )

    def moving_average(self, data, n, weights=None, restrict_strord=False, strord=None,
                       nodata=-9999.0):
        """Average over the ``n`` nearest cells up and down the main stream,
        on the device (``restrict_strord``: the downstream walk stops before
        a higher stream order, ``strord`` derived where None)."""
        out = arithmetics.moving_average(
            data=torch.as_tensor(self._check_data(data, "data"), device=self.device),
            weights=None if weights is None else torch.as_tensor(
                self._check_data(weights, "weights"), device=self.device),
            n=n,
            nodata=nodata,
            **self._window_args(strord, restrict_strord),
        )
        return out.cpu().numpy().reshape(np.asarray(data).shape)

    def moving_median(self, data, n, restrict_strord=False, strord=None, nodata=-9999.0):
        """Median over the window of :meth:`moving_average`, on the device."""
        out = arithmetics.moving_median(
            data=torch.as_tensor(self._check_data(data, "data"), device=self.device),
            n=n,
            nodata=nodata,
            **self._window_args(strord, restrict_strord),
        )
        return out.cpu().numpy().reshape(np.asarray(data).shape)

    def upstream_area(self):
        """Upstream area map based on the per-cell area."""
        area = torch.as_tensor(np.asarray(self.area).ravel(), device=self.device)
        uparea = self._accumulate_dev(area).cpu().numpy()
        uparea = np.where(np.asarray(self.mask), uparea, -9999)
        return uparea.reshape(self.shape)

    def fillnodata(self, data, nodata, direction="down", how="max"):
        """Fill nodata cells from the nearest valid value: ``direction="up"``
        takes the first valid value downstream of each cell, ``"down"`` the
        min, max or sum (``how``) over the nearest valid cells upstream."""
        direction = str(direction).lower()
        dflat = torch.as_tensor(self._check_data(data, "data"), device=self.device)
        if direction == "up":
            dout = graph.fillnodata_upstream(self._ds, dflat, nodata)
        elif direction == "down":
            dout = graph.fillnodata_downstream(self._ds, dflat, nodata, how=how)
        else:
            raise ValueError(
                f'Unknown flow direction: {direction}, select from ["up", "down"].'
            )
        return dout.cpu().numpy().reshape(np.asarray(data).shape)

    def accuflux(self, data, nodata=-9999, direction="up"):
        """Accumulated values along the flow directions: upstream sums
        (``direction="up"``; nodata cells keep nodata and cut the flow from
        their subtree, by pointer doubling) or the sum along each cell's
        downstream path (``"down"``)."""
        data_np = self._check_data(data, "data")
        if direction == "up":
            dflat = torch.as_tensor(data_np, device=self.device)
            if np.any(data_np == nodata):
                accu = streams.accuflux(self._ds, dflat, nodata=nodata, tree=self._tree)
            else:
                accu = self._accumulate_dev(dflat)
        elif direction == "down":
            accu = streams.accuflux_ds(
                self._ds, torch.as_tensor(data_np, device=self.device), nodata=nodata
            )
        else:
            raise ValueError(
                f'Unknown flow direction: {direction}, select from ["up", "down"].'
            )
        return accu.cpu().numpy().reshape(np.asarray(data).shape)

    def smooth_rivlen(self, rivlen, min_rivlen, max_window=10, nodata=-9999.0):
        """River lengths below ``min_rivlen`` smoothed over a window of up to
        ``max_window`` cells along the main stem (the native sequential
        sweep)."""
        out = streams.smooth_rivlen(
            self._idxs_ds,
            self.idxs_us_main,
            self._check_data(rivlen, "rivlen"),
            min_rivlen=min_rivlen,
            max_window=max_window,
            nodata=nodata,
        )
        return out.reshape(np.asarray(rivlen).shape)

    ### ELEVATION ###

    def dem_adjust(self, elevtn):
        """Hydrologically adjusted elevation, never above the cell upstream
        of it: the native profile repair (:func:`dem.adjust_elevation`) on
        the host, in ``elevtn``'s shape and dtype."""
        out = dem.adjust_elevation(
            self._idxs_ds, self.rank.ravel(), self._check_data(elevtn, "elevtn"))
        return out.reshape(np.asarray(elevtn).shape).astype(np.asarray(elevtn).dtype)

    ### RIVERS ###

    def classify_estuaries(self, elevtn, rivwth, rivdst=None, min_convergence=1e-2,
                           max_elevtn=0):
        """Estuaries by river-width convergence (:func:`rivers.classify_estuary`,
        on the device): flat int8, 1 estuary, 2 its upstream end, 0 else;
        ``rivdst`` defaults to :attr:`distnc`."""
        rivdst = self.distnc if rivdst is None else rivdst
        est = rivers.classify_estuary(
            self._ds,
            self.idxs_pit,
            rivdst=self._check_data(rivdst, "rivdst"),
            rivwth=self._check_data(rivwth, "rivwth"),
            elevtn=self._check_data(elevtn, "elevtn"),
            min_convergence=min_convergence,
            max_elevtn=max_elevtn,
            device=self.device,
        )
        return est.cpu().numpy()

    def river_depth(self, qbankfull, rivwth, zs=None, rivdst=None, rivslp=None, manning=0.03,
                    method="manning", min_rivdph=1, min_rivslp=1e-5, **kwargs):
        """River depth from Manning's equation, or refined by the
        gradually-varied-flow solver (``method="gvf"``,
        :func:`rivers.rivdph_gvf`); the slope from ``zs`` and ``rivdst``
        where ``rivslp`` is None. Host numpy float64, -9999 at missing
        cells."""
        methods = ["manning", "gvf"]
        if method not in methods:
            raise ValueError(f"Method unknown {method}, select from {methods}")
        manning = self._check_data(manning, "manning")
        qbankfull = self._check_data(qbankfull, "qbankfull")
        rivwth = self._check_data(rivwth, "rivwth")
        _opt = method == "manning" and rivslp is not None
        rivslp = self._check_data(rivslp, "rivslp", optional=True)
        rivdst = self._check_data(rivdst, "rivdst", optional=_opt)
        zs = self._check_data(zs, "zs", optional=_opt)
        if rivslp is None:
            dz = zs - self.downstream(zs)
            dx = rivdst - self.downstream(rivdst)
            rivslp = np.where(dx >= 1, dz / np.maximum(1, dx), -9999)
            rivslp = self.fillnodata(rivslp, nodata=-9999)
        rivslp = np.maximum(min_rivslp, rivslp)
        rivdph = ((manning * qbankfull) / (np.sqrt(rivslp) * rivwth)) ** (3 / 5)
        rivdph = np.maximum(min_rivdph, rivdph)
        rivdph[self.idxs_ds == self._mv] = -9999.0
        if method == "gvf":
            rivdph = rivers.rivdph_gvf(
                self._idxs_ds,
                self.rank.ravel(),
                zs=zs,
                rivdph=rivdph,
                qbankfull=qbankfull,
                rivdst=rivdst,
                rivwth=rivwth,
                manning=manning,
                min_rivslp=min_rivslp,
                min_rivdph=min_rivdph,
                **kwargs,
            )
        return np.asarray(rivdph).reshape(self.shape)

    ### STREAMS ###

    def stream_order(self, type="strahler", mask=None):
        """Strahler (default) or classic stream order (uint8). Strahler runs
        in the native host library over the DFS plan's preorder (cached where
        there is no mask); classic by pointer doubling on the device."""
        mask = self._check_data(mask, "mask", optional=True)
        if type.lower() == "strahler":
            if mask is None and "strord" in self._cached:
                return self._cached["strord"].reshape(self.shape)
            strord = runtime.strahler_order(
                self._idxs_ds, self._plan.preorder_np, mask=None if mask is None else mask != 0
            )
            if self.cache and mask is None:
                self._cached["strord"] = strord
        elif type.lower() == "classic":
            strord = streams.stream_order(
                self._ds,
                torch.as_tensor(self.idxs_us_main, device=self.device),
                mask=None if mask is None else torch.as_tensor(mask != 0, device=self.device),
            ).cpu().numpy()
        else:
            raise ValueError(f"Unknown stream order type: {type}")
        return strord.reshape(self.shape)

    ### SHORTCUTS ###

    def _check_data(self, data, name, optional=False, flatten=True, **kwargs):
        """Check the data's size (``flatten``) or shape and return it
        flattened or as given; a scalar is broadcast. None stays None where
        ``optional``; a None ``uparea`` or ``strord`` is derived
        (:meth:`upstream_area`, :meth:`stream_order` with ``kwargs``)."""
        if data is None and optional:
            return None
        if data is None:
            if name == "uparea":
                data = self.upstream_area(**kwargs)
            elif name == "strord":
                data = self.stream_order(**kwargs)
        data = np.atleast_1d(data)
        if flatten:
            if data.size == 1:
                data = np.full(self.size, data.item(), dtype=data.dtype)
            elif data.size != self.size:
                raise ValueError(f'"{name}" size does not match.')
            return np.ascontiguousarray(data.ravel())
        if data.size == 1:
            data = np.full(self.shape, data.item(), dtype=data.dtype)
        elif data.shape != self.shape:
            raise ValueError(f'"{name}" shape does not match.')
        return data

    def _check_idxs_xy(self, idxs, streams=None):
        """Linear indices, flattened; with ``streams``, each snapped
        downstream to the first ``streams`` cell or its pit."""
        idxs = np.atleast_1d(idxs).ravel()
        streams = self._check_data(streams, "streams", optional=True)
        if streams is not None:
            idxs = self.snap(idxs=idxs, mask=streams)[0]
        return idxs
