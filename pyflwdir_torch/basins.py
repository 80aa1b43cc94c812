"""Basin delineation: the basin map, the most downstream area of a region
and the three sub-basin partitions. Labels spread by pointer doubling
(:mod:`pyflwdir_torch.ops.graph`) on the graph's device; the Pfafstetter
and area partitions keep their short sequential bookkeeping over branch
outlets on the host (the area one in the native host library), on maps
computed on the device."""

from __future__ import annotations

import numpy as np
import torch

from ._backend import resolve_device
from .ops import graph
from .ops.order import classic_order

__all__ = [
    "basins",
    "interbasin_mask",
    "subbasins_streamorder",
    "subbasins_pfafstetter",
    "subbasins_area",
]


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


def interbasin_mask(idxs_ds, region, stream=None):
    """The most downstream contiguous area within ``region`` (bool tensors):
    the region cells with no region-entry cell (a cell outside the region
    draining into it) on their path to the pit, and, with ``stream``, whose
    pit has a ``stream`` cell upstream."""
    n = idxs_ds.shape[0]
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=idxs_ds.device)
    valid = idxs_ds >= 0
    root = graph.reach(idxs_ds, None)
    ds = graph.self_loop(idxs_ds)
    entry = valid & ~region & region[ds] & (ds != ar)
    keep = graph.path_sum(idxs_ds, entry.to(torch.int32)) == 0
    if stream is not None:
        keep = keep & (graph.accumulate(idxs_ds, stream.to(torch.int32)) > 0)[root]
    return valid & keep & region


def subbasins_streamorder(idxs_ds, strord, rank, mask=None, min_sto=-2):
    """Sub-basins split where the stream order changes. Outlets are the cells
    of order ``min_sto`` or more (below the highest order where negative)
    whose downstream cell has another order, or that are pits, numbered
    1, 2, ... up- to downstream: by decreasing ``rank`` (numpy), ties by
    index. Returns (int32 label tensor, numpy outlet indices)."""
    dev = idxs_ds.device
    strord = torch.as_tensor(strord, device=dev)
    if min_sto < 0:
        min_sto = int(strord.max()) + min_sto
    n = idxs_ds.shape[0]
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=dev)
    valid = idxs_ds >= 0
    live = valid & (strord >= min_sto)
    if mask is not None:
        live = live & mask
    ds = graph.self_loop(idxs_ds)
    is_out = live & ((strord != strord[ds]) | (ds == ar))
    idxs_out = np.flatnonzero(is_out.cpu().numpy())
    order = np.argsort(-np.asarray(rank).ravel()[idxs_out], kind="stable")
    idxs1 = idxs_out[order].astype(np.int64)
    seed = torch.zeros(n, dtype=torch.int32, device=dev)
    seed[torch.as_tensor(idxs1, device=dev)] = torch.arange(
        1, idxs1.size + 1, dtype=torch.int32, device=dev)
    t = graph.reach(idxs_ds, is_out)
    subbas = torch.where(valid & is_out[t], seed[t], torch.zeros_like(seed))
    return subbas, idxs1


def subbasins_pfafstetter(idxs_pit_np, idxs_ds, idxs_us_main, uparea, rank, mask=None,
                          depth=1):
    """Pfafstetter sub-basins to ``depth`` digits. The classic order (to
    ``depth + 1``) and the final upstream fill run on the device; the
    stems' subdivision runs on the host over the branch outlets, level by
    level: on each stem the four largest tributaries (by ``uparea``), from
    downstream up, take the odd codes and the stem above each confluence
    the next even code. Returns (int32 label tensor, numpy outlet
    indices). ``rank`` is not read; it stays for the JAX signature."""
    n = idxs_ds.shape[0]
    strord = classic_order(idxs_ds, idxs_us_main, mask=mask)
    strord = torch.where(strord <= depth + 1, strord, torch.zeros_like(strord))
    strord_np = strord.cpu().numpy()
    ds_np = graph.self_loop(idxs_ds).cpu().numpy()
    us_main_np = torch.as_tensor(idxs_us_main).cpu().numpy()
    upa_np = torch.as_tensor(uparea).cpu().numpy()

    # tributaries: strord > 0 and above that of their downstream cell
    idxs_trib = np.where((strord_np > 0) & (strord_np > strord_np[ds_np]))[0]

    pfaf = np.zeros(n, dtype=np.int64)
    outlets = []
    registered = set()

    def _stem(outlet):
        """The main-stem cells strictly upstream of ``outlet`` within the
        depth-limited stream network."""
        cells = []
        j = int(us_main_np[outlet])
        while j >= 0 and strord_np[j] != 0:
            cells.append(j)
            j = int(us_main_np[j])
        return np.asarray(cells, dtype=np.int64)

    def _register(outlet, code, stem):
        pfaf[outlet] = code
        if stem.size:
            pfaf[stem] = code
        outlets.append(int(outlet))
        registered.add(int(outlet))

    base = sum(10**d for d in range(depth))  # 1, 11, 111, ...
    level = []  # (outlet-first stem incl. outlet, code, subdivision depth)
    for i, pit in enumerate(np.asarray(idxs_pit_np)):
        code = base + (i + 1) * 10**depth
        stem = _stem(int(pit))
        _register(int(pit), code, stem)
        level.append((np.concatenate([[int(pit)], stem]), code, 1))

    while level:
        deeper = []
        for stem, code, d0 in level:
            step = 10 ** (depth - d0)
            # unlabelled tributaries whose confluence lies on this stem
            order = np.argsort(stem, kind="stable")
            ssort = stem[order]
            dst = ds_np[idxs_trib]
            p = np.clip(np.searchsorted(ssort, dst), 0, stem.size - 1)
            on = (ssort[p] == dst) & (pfaf[idxs_trib] == 0)
            cand = idxs_trib[on]
            if cand.size == 0:
                continue
            cpos = order[p[on]]  # the confluence's position along the stem
            big4 = np.argsort(-upa_np[cand], kind="stable")[:4]
            dsf = np.argsort(cpos[big4], kind="stable")  # downstream first
            for i, (trib, p0) in enumerate(zip(cand[big4][dsf], cpos[big4][dsf])):
                tstem = _stem(int(trib))
                _register(int(trib), code + (2 * i + 1) * step, tstem)
                if d0 < depth:
                    deeper.append((np.concatenate([[int(trib)], tstem]),
                                   code + (2 * i + 1) * step, d0 + 1))
                # the interbasin: the parent stem above this confluence
                seg = stem[p0 + 1:]
                ib = int(seg[0]) if seg.size else int(us_main_np[stem[p0]])
                if ib < 0 or ib in registered:
                    continue
                code_ib = code + (2 * i + 2) * step
                _register(ib, code_ib, seg)
                if d0 < depth:
                    child = seg if seg.size else np.asarray([ib], dtype=np.int64)
                    deeper.append((child, code_ib, d0 + 1))
        level = deeper

    idxs1 = np.array(outlets, dtype=np.int64)
    filled = graph.fillnodata_upstream(idxs_ds, torch.as_tensor(pfaf, device=idxs_ds.device), 0)
    return (filled % 10**depth).to(torch.int32), idxs1


def subbasins_area(idxs_ds_np, rank_np, idxs_us_main_np, uparea_np, area_min, device=None):
    """Sub-basins of at least ``area_min``: the down- to upstream sweep that
    carries each cell's unclaimed area is sequential and runs in the native
    host library (``runtime.subbasin_area_outlets``); the outlet labels then
    spread upstream on ``device`` (None: the card). Returns (uint32 labels,
    outlet indices in ``idxs_ds_np``'s dtype), numpy."""
    from .runtime import subbasin_area_outlets as _native

    device = resolve_device(device)
    idxs_ds_np = np.asarray(idxs_ds_np)
    rank_np = np.asarray(rank_np).ravel()
    valid = rank_np >= 0
    seq = np.where(valid)[0][np.argsort(rank_np[valid], kind="stable")]  # down- to upstream
    labels, idxs1 = _native(idxs_ds_np, np.asarray(idxs_us_main_np), seq,
                            np.asarray(uparea_np), float(area_min))
    # torch has few uint32 operations: the labels spread as int64
    filled = graph.fillnodata_upstream(
        torch.as_tensor(idxs_ds_np, device=device),
        torch.as_tensor(labels.astype(np.int64), device=device), 0)
    return filled.cpu().numpy().astype(np.uint32), idxs1.astype(idxs_ds_np.dtype)
