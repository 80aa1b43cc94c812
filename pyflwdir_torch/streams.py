"""Stream maps over the flow network, the subset ported so far: downstream
accumulation and the distance to the outlet, by pointer doubling
(:mod:`pyflwdir_torch.ops.graph`). Functions take and return tensors."""

from __future__ import annotations

import numpy as np
import torch

from .ops import graph
from .utils import geodesy
from .utils.affine import IDENTITY

__all__ = ["accuflux_ds", "stream_distance"]


def accuflux_ds(idxs_ds, data, nodata=-9999):
    """Accumulated downstream ``data``: the sum over each cell's path to its
    pit; nodata cells stay nodata and cut the paths above them."""
    return graph.accumulate_downstream(idxs_ds, data, nodata=nodata)


def stream_distance(
    idxs_ds,
    shape,
    mask=None,
    real_length=True,
    latlon=False,
    transform=IDENTITY,
    edge_length=None,
):
    """Distance to the outlet, or to the next downstream True cell of
    ``mask`` (such cells are at distance 0): float32 metres, or int32 cells
    where not ``real_length``; -9999 at missing cells."""
    n = idxs_ds.shape[0]
    if real_length:
        if edge_length is None:
            edge_length = torch.as_tensor(
                np.asarray(
                    geodesy.distance_grid(
                        idxs_ds.cpu().numpy(), shape, latlon=latlon, transform=transform
                    ),
                    dtype=np.float32,
                ).ravel(),
                device=idxs_ds.device,
            )
        w = edge_length.to(torch.float32)
    else:
        w = torch.ones(n, dtype=torch.int32, device=idxs_ds.device)
    dist = graph.path_sum(idxs_ds, w, stop=mask)
    return torch.where(idxs_ds >= 0, dist, torch.full_like(dist, -9999))
