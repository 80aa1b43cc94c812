"""Stream order: the Strahler fixpoint, Strahler through the tile plan, and
classic (Hack) order, in plain PyTorch on the graph's device.

* :func:`strahler_order` recomputes, each round, every cell's order as the
  largest upstream order plus one where two or more upstream cells reach it;
  it converges in as many rounds as the confluence tree is high.
* :func:`strahler_tile_plan` runs one order level a round: a cell is of
  order ``s + 1`` or more where its subtree holds a cell of order ``s`` with
  two upstream cells of order ``s``. Each level is a child count and one int32
  :meth:`pyflwdir_torch.ops.tile_plan.TilePlan.accumulate` (kernels T1, the
  coarse level's H1-H3, T2), about log2 of the headwaters in all.
* :func:`classic_order` is one plus the tributary junctions on a cell's path
  to its pit: one path sum.

Each matches the sequential sweep over the cells (the native
``runtime.strahler_order`` / ``classic_order``) bit for bit.
"""

from __future__ import annotations

import torch

from ..codecs import d8 as d8c
from .graph import path_sum, reach, self_loop, upstream_count

__all__ = ["strahler_order", "strahler_tile_plan", "classic_order", "d8_codes"]


def strahler_order(idxs_ds, mask=None, max_rounds=None):
    """Strahler ("top down") stream order (uint8). Cells outside ``mask``
    are 0 and add nothing downstream."""
    n = idxs_ds.shape[0]
    dev = idxs_ds.device
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=dev)
    valid = idxs_ds >= 0
    if mask is not None:
        valid = valid & mask
    send = valid & (idxs_ds != ar)
    tgt = torch.where(send, idxs_ds, torch.full_like(idxs_ds, n))
    tgt_c = tgt.clamp(max=n - 1)
    if max_rounds is None:
        max_rounds = n  # the early exit ends the loop after the tree's height
    sto = valid.to(torch.int32)
    for _ in range(max_rounds):
        vals = torch.where(send, sto, torch.zeros_like(sto))
        m = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        m = m.scatter_reduce_(0, tgt, vals, reduce="amax", include_self=True)[:n]
        hit = torch.where(send & (sto == m[tgt_c]), tgt, torch.full_like(tgt, n))
        cnt = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        cnt = cnt.index_add_(0, hit, torch.ones_like(sto))[:n]
        new = torch.where(m > 0, m + (cnt >= 2).to(torch.int32), torch.ones_like(m))
        new = torch.where(valid, new, torch.zeros_like(new))
        changed = bool((new != sto).any())
        sto = new
        if not changed:
            break
    return sto.clamp(0, 255).to(torch.uint8)


def d8_codes(idxs_ds, shape):
    """The D8 raster of ``idxs_ds`` on its device: the values of
    :func:`pyflwdir_torch.codecs.d8.to_array` (uint8, ``shape``), pits 0 and
    missing cells 247, computed on the device instead of over the host
    array."""
    ncol = int(shape[1])
    dev = idxs_ds.device
    ar = torch.arange(idxs_ds.shape[0], dtype=torch.int64, device=dev)
    valid = idxs_ds >= 0
    ds = torch.where(valid, idxs_ds, ar)
    dr = torch.div(ds, ncol, rounding_mode="floor") - torch.div(ar, ncol, rounding_mode="floor")
    dc = ds % ncol - ar % ncol
    if bool((valid & ((dr.abs() > 1) | (dc.abs() > 1))).any()):
        raise ValueError("Invalid data downstream index outside 8 neighbors.")
    enc = torch.as_tensor(d8c._ENC_LUT, device=dev)
    code = enc[((dr + 1) * 3 + (dc + 1)).clamp(0, 8)]
    return torch.where(valid, code, torch.full_like(code, int(d8c._mv))).reshape(shape)


def _d8_targets(codes, mask=None, device=None):
    """``(member, tgt)`` of a (H, W) D8 raster (numpy or a tensor) on
    ``device`` (the tensor's where None), both flat: ``member``, the valid
    cells (within ``mask``); ``tgt`` (int32), the cell each D8 step lands on
    inside the grid, ``n`` for pits, missing cells and steps off the
    grid."""
    dev = codes.device if device is None else device
    nrow, ncol = codes.shape
    n = nrow * ncol
    c = torch.as_tensor(codes, device=dev).reshape(-1).long()
    dr = torch.as_tensor(d8c._DR_LUT, device=dev)[c].long()
    dc = torch.as_tensor(d8c._DC_LUT, device=dev)[c].long()
    member = (dr != 0) | (dc != 0) | torch.isin(c, torch.as_tensor(d8c._pv, device=dev).long())
    if mask is not None:
        member = member & torch.as_tensor(mask, device=dev).reshape(-1).bool()
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    r = torch.div(ar, ncol, rounding_mode="floor") + dr
    col = ar % ncol + dc
    inside = (r >= 0) & (r < nrow) & (col >= 0) & (col < ncol) & ((dr != 0) | (dc != 0))
    tgt = torch.where(inside, r * ncol + col, torch.full_like(ar, n)).to(torch.int32)
    return member, tgt


def _strahler_grids(codes, tp, mask):
    """The level loop's grids (:func:`_d8_targets`) on the plan's device,
    cached on the plan and keyed by the identity of ``codes`` and ``mask``
    (the cache holds both, so their ids cannot be taken by other arrays)."""
    cached = getattr(tp, "_strahler_grids", None)
    if cached is not None and cached[0] is codes and cached[1] is mask:
        return cached[2], cached[3]
    member, tgt = _d8_targets(codes, mask, tp.device)
    tp._strahler_grids = (codes, mask, member, tgt)
    return member, tgt


def _child_counts(member, tgt):
    """The ``member`` cells whose D8 step lands on each cell inside the grid
    (int32; ``tgt`` from :func:`_d8_targets`): one ``index_add_`` of the
    members' targets, the count the JAX package's eight shifted adds make."""
    src = tgt[member]
    cnt = torch.zeros(member.numel() + 1, dtype=torch.int32, device=member.device)
    cnt.index_add_(0, src, torch.ones(src.numel(), dtype=torch.int32, device=member.device))
    return cnt[:-1]


def _generators(member, tgt):
    """A level's confluence cells: the members that two or more members
    drain into. The count scatters the members' targets only: the members
    thin out level by level, so this costs a fraction of a scatter over
    every cell after the first level (``tools/bench_strahler_count.py``
    times both)."""
    return (_child_counts(member, tgt) >= 2) & member


def strahler_tile_plan(codes, tp, arrs=None, mask=None, max_order=32):
    """Strahler order (uint8, ``codes``' shape) of a raster above the
    tile-plan threshold, through the tile plan ``tp`` on its device.

    ``codes``: the (H, W) D8 raster (numpy or a tensor), already cut to
    ``mask`` where one applies, and ``tp`` built on the same cut graph.
    Cells outside ``mask`` are 0. At most ``max_order - 1`` levels run.
    ``arrs`` (the JAX plan's device tables) is accepted for the JAX
    signature and not used: the port's plan holds its tables.

    Level by level: ``cnt`` counts the ``member`` cells whose D8 step lands
    on each cell inside the grid (one ``index_add_`` of the members'
    targets; the same count as the JAX package's eight rolls with the
    wrapped row or column zeroed); ``gen
    = (cnt >= 2) & member``; while ``gen`` has a cell, the members that
    ``accumulate(gen)`` reaches stay members and their order grows by one.
    Two host syncs a level (the members' count, ``gen.any()``), besides
    the accumulation's own."""
    member, tgt = _strahler_grids(codes, tp, mask)
    order = member.to(torch.uint8)
    for _ in range(1, max_order):
        gen = _generators(member, tgt)
        if not bool(gen.any()):
            break
        accu = tp.accumulate(gen.to(torch.int32))
        member = (accu >= 1) & member
        order += member.to(torch.uint8)
    return order.reshape(tp.shape)


def classic_order(idxs_ds, idxs_us_main, mask=None):
    """Classic (Hack, "bottom up") stream order (uint8): main stems 1, each
    tributary one above the stream it joins; cells outside ``mask`` are 0
    and read as order 0 by the cells above them."""
    n = idxs_ds.shape[0]
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=idxs_ds.device)
    valid = idxs_ds >= 0
    live = valid if mask is None else (valid & mask)
    nup = upstream_count(idxs_ds, mask=mask)
    ds = self_loop(idxs_ds)
    # a hop: the cell starts a tributary (is not the main upstream cell of a confluence)
    is_trib = (nup[ds] > 1) & (idxs_us_main[ds] != ar) & (ds != ar)
    hops = (live & is_trib).to(torch.int32)
    if mask is None:
        order = 1 + path_sum(idxs_ds, hops)
    else:
        stop = valid & ~mask  # masked cells read as order 0
        base = (valid & mask[reach(idxs_ds, stop)]).to(torch.int32)
        order = base + path_sum(idxs_ds, hops, stop=stop)
    order = torch.where(live, order, torch.zeros_like(order))
    return order.clamp(0, 255).to(torch.uint8)
