"""DEM conditioning, the subset the port needs so far: edge cells, the
exact host priority-flood depression fill that turns a DEM into D8 codes,
and the height above the nearest drain.

The first two run on the host (numpy and the native library); the device
fill is queued for a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fill_depressions", "get_edge", "height_above_nearest_drain"]


def get_edge(a, structure=None):
    """Edge cells of the valid mask: a valid cell on the array border, or
    with any structuring-element neighbor invalid (upstream pyflwdir
    ``gis_utils.get_edge``)."""
    a = np.asarray(a, dtype=bool)
    if structure is None:
        structure = np.ones((3, 3), dtype=bool)
    nrow, ncol = a.shape
    pad = np.pad(a, 1, mode="constant", constant_values=False)
    all_nb = np.ones_like(a)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if structure[dr + 1, dc + 1]:
                all_nb &= pad[1 + dr : 1 + dr + nrow, 1 + dc : 1 + dc + ncol]
    edge = a.copy()
    interior = np.zeros_like(a)
    interior[1:-1, 1:-1] = True
    edge[interior & all_nb] = False
    return edge


def fill_depressions(
    elevtn,
    outlets="edge",
    idxs_pit=None,
    nodata=-9999.0,
    max_depth=-1.0,
    elv_max=None,
    connectivity=8,
):
    """Fill local depressions and derive D8 flow directions.

    Exact Wang & Liu (2006) priority-flood (upstream pyflwdir
    ``dem.py:18-143``): seeds at valid-edge cells ('edge'), the single lowest
    edge cell ('min') or user pits; the D8 direction of each cell points to
    the cell that popped it. Runs the native kernel
    (``csrc/host_kernels.cpp::priority_flood``). Returns ``(filled, d8)``.
    """
    from .runtime import priority_flood

    return priority_flood(
        np.asarray(elevtn),
        outlets=outlets,
        idxs_pit=idxs_pit,
        nodata=nodata,
        max_depth=max_depth,
        elv_max=elv_max,
        connectivity=connectivity,
    )


def height_above_nearest_drain(idxs_ds, drain, elevtn):
    """HAND: the drop from each cell to the first drain cell (else the pit)
    downstream of it; 0 at drain cells, -9999 at missing cells. Tensors in,
    a tensor of ``elevtn``'s float dtype (float32 for integers) out."""
    from .ops import graph

    drain = drain != 0
    z = elevtn if elevtn.dtype.is_floating_point else elevtn.to(torch.float32)
    hand = z - z[graph.reach(idxs_ds, drain)]
    hand = torch.where(drain, torch.zeros_like(hand), hand)
    return torch.where(idxs_ds >= 0, hand, torch.full_like(hand, -9999.0))
