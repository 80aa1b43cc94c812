"""Basin delineation, the subset ported so far: the basin map, by pointer
doubling (:mod:`pyflwdir_torch.ops.graph`)."""

from __future__ import annotations

import numpy as np
import torch

from .ops import graph

__all__ = ["basins"]


def basins(idxs_ds, idxs_pit, ids=None):
    """Basin map: every cell labelled with the id of the outlet in
    ``idxs_pit`` it drains to (1, 2, ... unless ``ids`` is given), 0 where it
    drains to none. ``idxs_ds`` is a tensor; returns a numpy array of the
    ids' dtype (uint32 by default)."""
    idxs_pit = np.asarray(idxs_pit, dtype=np.int64)
    if ids is None:
        ids = np.arange(1, idxs_pit.size + 1, dtype=np.uint32)
    ids = np.asarray(ids)
    n = idxs_ds.shape[0]
    seed = np.zeros(n, dtype=ids.dtype)
    seed[idxs_pit] = ids
    stop = torch.zeros(n, dtype=torch.bool, device=idxs_ds.device)
    stop[torch.as_tensor(idxs_pit, device=idxs_ds.device)] = True
    # pointers frozen at the seeded cells, so labels spread from them
    t = graph.reach(idxs_ds, stop).cpu().numpy()
    return np.where(idxs_ds.cpu().numpy() >= 0, seed[t], 0).astype(ids.dtype)
