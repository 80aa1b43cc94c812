"""Flwdir: the graph-only flow-direction object, the subset ported so far.

Same constructor contract and accumulation dispatch as the JAX package's
``Flwdir``; inputs and outputs are numpy arrays, and the graph, its plans
and the accumulation run on the object's ``device`` (CUDA unless the
caller asks for the CPU). ``idxs_ds`` is int64.
"""

from __future__ import annotations

import numpy as np
import torch

from . import streams
from ._backend import resolve_device
from .ops import graph

__all__ = ["Flwdir"]

_LATER = "is queued for a later slice of the PyTorch port (streams.py)"


class Flwdir:
    """Flow direction parsed to general actionable format.

    ``idxs_ds[i] == i`` marks a pit, a negative value a missing cell.
    """

    def __init__(
        self,
        idxs_ds,
        idxs_pit=None,
        idxs_outlet=None,
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
        self._nnodes = nnodes
        self.device = resolve_device(device)
        self.cache = cache
        self._cached = dict()
        if self.idxs_pit.size == 0:
            raise ValueError("Invalid FlwdirRaster: no pits found")

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

    def _accel(self):
        """Cached single-chunk router plan (ops.accel.AccelPlan)."""
        if "accel" not in self._cached:
            from .ops.accel import build_accel_plan

            self._cached["accel"] = build_accel_plan(
                self._idxs_ds, self._plan, device=self.device
            )
        return self._cached["accel"]

    def _accumulate_dev(self, data):
        """Flow accumulation of a device tensor, dispatched as the JAX
        package does: integer data whose total may reach 2^24 takes the
        exact int64 DFS plan; other integer data the float32 router plan
        (kernels H0-H3); float data the float64 DFS plan."""
        aplan = self._accel()
        is_int = not data.dtype.is_floating_point
        # the router plan sums in float32: exact for integer totals below 2^24
        if is_int and data.numel() and data.dtype != torch.bool:
            lo, hi = torch.aminmax(data)  # one read, no int64 copy
            amax = max(-int(lo), int(hi))
            if amax * data.numel() >= 1 << 24:
                from .ops.plan import accumulate_planned

                return accumulate_planned(self._plan, data)
        if is_int:
            return aplan.accumulate(data)
        from .ops.plan import accumulate_planned_fast

        return accumulate_planned_fast(self._plan, data)

    ### PROPERTIES ###

    @property
    def idxs_ds(self):
        """Linear indices of downstream cell (int64)."""
        return self._idxs_ds

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
    def mask(self):
        """Boolean array of valid cells."""
        return self.idxs_ds != self._mv

    @property
    def area(self):
        """Cell area (graph objects default to unit areas)."""
        return np.ones(self.size, dtype=np.float32)

    ### GLOBAL ARITHMETICS ###

    def upstream_area(self):
        """Upstream area map based on the per-cell area."""
        area = torch.as_tensor(np.asarray(self.area).ravel(), device=self.device)
        uparea = self._accumulate_dev(area).cpu().numpy()
        uparea = np.where(np.asarray(self.mask), uparea, -9999)
        return uparea.reshape(self.shape)

    def fillnodata(self, data, nodata, direction="down", how="max"):
        """Fill nodata cells from the nearest valid value: ``direction="up"``
        takes the first valid value downstream of each cell."""
        direction = str(direction).lower()
        dflat = torch.as_tensor(self._check_data(data, "data"), device=self.device)
        if direction == "up":
            dout = graph.fillnodata_upstream(self._ds, dflat, nodata)
        elif direction == "down":
            raise NotImplementedError(
                'fillnodata(direction="down") is queued for a later slice of the '
                "PyTorch port (ops/graph.py subtree reductions)"
            )
        else:
            raise ValueError(
                f'Unknown flow direction: {direction}, select from ["up", "down"].'
            )
        return dout.cpu().numpy().reshape(np.asarray(data).shape)

    def accuflux(self, data, nodata=-9999, direction="up"):
        """Accumulated values along the flow directions: upstream sums
        (``direction="up"``, data without ``nodata`` values) or the sum along
        each cell's downstream path (``"down"``)."""
        data_np = self._check_data(data, "data")
        if direction == "up":
            if np.any(data_np == nodata):
                raise NotImplementedError(
                    f"accuflux of data holding nodata values {_LATER}"
                )
            accu = self._accumulate_dev(torch.as_tensor(data_np, device=self.device))
        elif direction == "down":
            accu = streams.accuflux_ds(
                self._ds, torch.as_tensor(data_np, device=self.device), nodata=nodata
            )
        else:
            raise ValueError(
                f'Unknown flow direction: {direction}, select from ["up", "down"].'
            )
        return accu.cpu().numpy().reshape(np.asarray(data).shape)

    ### SHORTCUTS ###

    def _check_data(self, data, name, optional=False):
        """Check the data size and return it flattened (a scalar is
        broadcast); None stays None where ``optional``."""
        if data is None and optional:
            return None
        data = np.atleast_1d(data)
        if data.size == 1:
            data = np.full(self.size, data.item(), dtype=data.dtype)
        elif data.size != self.size:
            raise ValueError(f'"{name}" size does not match.')
        return np.ascontiguousarray(data.ravel())

    def _check_idxs_xy(self, idxs, streams=None):
        """Linear indices, flattened. Snapping them to ``streams`` is not
        ported yet."""
        if streams is not None:
            raise NotImplementedError(f"snapping indices to streams {_LATER}")
        return np.atleast_1d(idxs).ravel()
