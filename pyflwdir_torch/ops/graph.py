"""Flow-graph primitives by pointer doubling, in plain PyTorch.

Data contract: ``idxs_ds`` is a 1-D int64 tensor of next-downstream
indices; ``idxs_ds[i] == i`` marks a pit, ``-1`` a missing cell. Each
doubling round is a whole-array gather; the loop stops when the pointers
converge, and after at most ``ceil(log2 n) + 1`` rounds.

The index sets at the end (:func:`pit_indices` .. :func:`upstream_matrix`)
have lengths the data decides: they come back to the host as int64 numpy
arrays, the device ones from :func:`rank` and :func:`upstream_count`.

The subtree reductions (:func:`accumulate`, :func:`fillnodata_downstream`)
scatter up the tree in each round: integer sums by ``index_add_``, maxima
and minima by ``scatter_reduce_``, all exact in any order. Float sums go
through :func:`_sum_by_target`, which adds in an order fixed by the data
alone, so that two calls give the same bits on the card, where the
atomics of ``index_add_`` land in any order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "self_loop",
    "valid_mask",
    "pit_mask",
    "rank",
    "roots",
    "reach",
    "path_reduce",
    "path_sum",
    "accumulate",
    "accumulate_downstream",
    "upstream_count",
    "main_upstream",
    "fillnodata_upstream",
    "fillnodata_downstream",
    "propagate_downstream",
    "pit_indices",
    "loop_indices",
    "headwater_indices",
    "confluence_indices",
    "flwdir_tuples",
    "idxs_seq",
    "upstream_matrix",
]


def _n_rounds(n: int) -> int:
    """Doubling-round bound: enough to traverse any simple path."""
    return max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)


def self_loop(idxs_ds: torch.Tensor) -> torch.Tensor:
    """Replace missing (-1) pointers with self-loops."""
    ar = torch.arange(idxs_ds.shape[0], dtype=idxs_ds.dtype, device=idxs_ds.device)
    return torch.where(idxs_ds < 0, ar, idxs_ds)


def valid_mask(idxs_ds: torch.Tensor) -> torch.Tensor:
    """True for active (non-missing) cells."""
    return idxs_ds >= 0


def pit_mask(idxs_ds: torch.Tensor) -> torch.Tensor:
    """True for pit cells (``idxs_ds[i] == i``)."""
    ar = torch.arange(idxs_ds.shape[0], dtype=idxs_ds.dtype, device=idxs_ds.device)
    return idxs_ds == ar


def rank(idxs_ds: torch.Tensor) -> torch.Tensor:
    """Distance to pit counted in cells (int32); loops -1, missing -9999.

    A cell is on (or drains into) a cycle iff its converged pointer does not
    land on an original pit: cycles whose length is a power of two collapse
    to self-loops under doubling, so convergence alone does not tell.
    """
    n = idxs_ds.shape[0]
    p = self_loop(idxs_ds)
    valid = idxs_ds >= 0
    ispit0 = pit_mask(idxs_ds)
    d = (valid & ~ispit0).to(torch.int64 if n > 2**30 else torch.int32)
    for _ in range(_n_rounds(n)):
        pp = p[p]
        if not bool((pp != p).any()):
            break
        d = d + d[p]
        p = pp
    ranks = torch.where(ispit0[p], d, torch.full_like(d, -1)).to(torch.int32)
    return torch.where(valid, ranks, torch.full_like(ranks, -9999))


def roots(idxs_ds: torch.Tensor) -> torch.Tensor:
    """Index of the pit each cell drains to; cycle cells get a cell of their
    cycle; missing cells map to themselves."""
    return reach(idxs_ds, None)


def reach(idxs_ds: torch.Tensor, stop: torch.Tensor | None) -> torch.Tensor:
    """First downstream cell (inclusive) where ``stop`` is True, else the pit."""
    p = self_loop(idxs_ds)
    if stop is not None:
        ar = torch.arange(p.shape[0], dtype=p.dtype, device=p.device)
        p = torch.where(stop, ar, p)
    for _ in range(_n_rounds(p.shape[0])):
        pp = p[p]
        if not bool((pp != p).any()):
            break
        p = pp
    return p


def _identity(op: str, dtype: torch.dtype):
    if op == "add":
        return 0
    if dtype.is_floating_point:
        return -math.inf if op == "max" else math.inf
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def path_reduce(idxs_ds, weights, stop=None, op="add"):
    """Half-open reduction (add, min or max) along the downstream path:
    ``out[i]`` reduces ``weights[j]`` over the path from ``i`` to its
    terminal cell (the first ``stop`` cell, else the pit), the terminal
    excluded. Pits and stop cells get the identity (0, +inf, -inf)."""
    if op not in ("add", "min", "max"):
        raise ValueError(f"unknown reduction: {op}")
    n = idxs_ds.shape[0]
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=idxs_ds.device)
    p = self_loop(idxs_ds)
    if stop is not None:
        p = torch.where(stop, ar, p)
    ident = torch.full((), _identity(op, weights.dtype), dtype=weights.dtype,
                       device=weights.device)
    combine = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
    c = torch.where(p != ar, weights, ident)
    for _ in range(_n_rounds(n)):
        pp = p[p]
        if not bool((pp != p).any()):
            break
        c = combine(c, torch.where(p != ar, c[p], ident))
        p = pp
    return c


def path_sum(idxs_ds, weights, stop=None):
    """Half-open additive carry along the downstream path (see
    :func:`path_reduce`)."""
    return path_reduce(idxs_ds, weights, stop=stop, op="add")


def accumulate_downstream(idxs_ds, data, nodata=None):
    """Downstream accumulation: ``out[i]`` sums ``data`` over the path from
    ``i`` to its pit, both ends included. With ``nodata``, nodata cells stay
    nodata and cut the path: cells upstream of one accumulate only up to
    (excluding) it."""
    if nodata is None:
        return path_sum(idxs_ds, data) + data[reach(idxs_ds, None)]
    block = data == nodata
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    t = reach(idxs_ds, block)  # first nodata cell downstream, else the pit
    s = path_sum(idxs_ds, torch.where(block, zero, data), stop=block)
    out = s + torch.where(block[t], zero, data[t])
    return torch.where((idxs_ds >= 0) & ~block, out, data)


def _sum_by_target(target, vals, n):
    """``out[i]`` sums ``vals[j]`` over the ``j`` with ``target[j] == i``
    (``target`` ``n`` drops), in an order fixed by the data: the terms
    sorted by target (stable), then a segmented doubling scan over each run
    of one target (``v[k] += v[k - d]`` where ``k - d`` lies in the run, d =
    1, 2, 4, ...), its last value the run's sum. A run of L terms adds along
    a chain of ceil(log2 L) additions; the bits are the same from call to
    call and on the CPU and the card."""
    keep = target < n
    t, v = target[keep], vals[keep]
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    m = t.numel()
    if m == 0:
        return out
    t, perm = torch.sort(t, stable=True)
    v = v[perm]
    d = 1
    while d < m:
        same = t[d:] == t[:-d]
        if not bool(same.any()):  # every run is shorter than d: the scan is done
            break
        v = torch.cat([v[:d], torch.where(same, v[d:] + v[:-d], v[d:])])
        d *= 2
    last = torch.ones(m, dtype=torch.bool, device=t.device)
    last[:-1] = t[1:] != t[:-1]
    out[t[last]] = v[last]
    return out


def _scatter(target, vals, n, op):
    """``out[i]`` reduces (add, max or min) ``vals[j]`` over the ``j`` with
    ``target[j] == i``: the identity where there is none; ``target`` ``n``
    drops."""
    if op == "add":
        if vals.dtype.is_floating_point:
            return _sum_by_target(target, vals, n)
        base = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
        return base.index_add_(0, target, vals)[:n]
    base = torch.full((n + 1,), _identity(op, vals.dtype), dtype=vals.dtype,
                      device=vals.device)
    red = "amax" if op == "max" else "amin"
    return base.scatter_reduce_(0, target, vals, reduce=red, include_self=True)[:n]


def _subtree_reduce(ptr0, values, op):
    """Subtree reduction by pointer doubling: ``ptr0[j]`` is ``j``'s
    forwarding target, or ``n`` where ``j`` does not forward. Returns, for
    every cell ``i``, the reduction (add, min or max) of ``values`` over all
    cells whose forwarding chain passes through ``i``, ``i`` included.

    After round m, ``s[i]`` reduces the subtree cut at depth ``2^m`` and
    ``p[j]`` is ``j``'s ``2^m``-step target (``n`` once the chain ends)."""
    n = ptr0.shape[0]
    combine = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
    sentinel = torch.full((1,), n, dtype=ptr0.dtype, device=ptr0.device)
    s, p = values, ptr0
    for _ in range(_n_rounds(n)):
        if not bool((p < n).any()):
            break
        s = combine(s, _scatter(p, s, n, op))
        p = torch.cat([p, sentinel])[p]
    return s


def accumulate(idxs_ds, data, tree=None, nodata=None):
    """Flow accumulation by pointer doubling: ``out[i]`` sums ``data`` over
    the subtree of ``i``.

    ``tree``: the cells that reach a pit; cells outside it (missing, on or
    above a cycle) add nothing and keep ``data``. None takes every valid
    cell. ``nodata``: nodata cells keep ``data``, add nothing and cut the
    flow from their subtree, without changing the cells below them."""
    n = idxs_ds.shape[0]
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=idxs_ds.device)
    ok = (idxs_ds >= 0) if tree is None else tree
    if nodata is not None:
        ok = ok & (data != nodata)
    ptr = torch.where(ok & (idxs_ds != ar), idxs_ds, torch.full_like(idxs_ds, n))
    s = torch.where(ok, data, torch.zeros((), dtype=data.dtype, device=data.device))
    s = _subtree_reduce(ptr, s, "add")
    return torch.where(ok, s, data)


def upstream_count(idxs_ds, mask=None):
    """Number of direct upstream cells (int8), -9 at missing cells. Cells
    outside ``mask`` count as no one's upstream cell, but get a count."""
    n = idxs_ds.shape[0]
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=idxs_ds.device)
    valid = idxs_ds >= 0
    send = valid & (idxs_ds != ar)
    if mask is not None:
        send = send & mask
    tgt = torch.where(send, idxs_ds, torch.full_like(idxs_ds, n))
    counts = torch.zeros(n + 1, dtype=torch.int32, device=idxs_ds.device)
    counts.index_add_(0, tgt, torch.ones(n, dtype=torch.int32, device=idxs_ds.device))
    counts = torch.where(valid, counts[:n], torch.full_like(counts[:n], -9))
    return counts.to(torch.int8)


def main_upstream(idxs_ds, uparea, upa_min=0.0):
    """Index of the upstream cell with the largest ``uparea`` (above
    ``upa_min``), -1 where there is none; of equal ones the lowest index, as
    the sequential scan keeps the first: a scatter-max of ``uparea``, then a
    scatter-min of the candidates' indices."""
    n = idxs_ds.shape[0]
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=idxs_ds.device)
    sent = torch.full_like(idxs_ds, n)
    send = (idxs_ds >= 0) & (idxs_ds != ar)
    tgt = torch.where(send, idxs_ds, sent)
    neg = torch.full((), _identity("max", uparea.dtype), dtype=uparea.dtype,
                     device=uparea.device)
    upa_max = _scatter(tgt, torch.where(send, uparea, neg), n, "max")
    is_cand = send & (uparea == upa_max[tgt.clamp(max=n - 1)]) & (uparea > upa_min)
    best = torch.full((n + 1,), n, dtype=idxs_ds.dtype, device=idxs_ds.device)
    best.scatter_reduce_(0, torch.where(is_cand, tgt, sent), torch.where(is_cand, ar, sent),
                         reduce="amin", include_self=True)
    best = best[:n]
    return torch.where(best < n, best, torch.full_like(best, -1))


def fillnodata_upstream(idxs_ds, data, nodata):
    """Fill nodata cells with the first valid value downstream; cells whose
    whole downstream path is nodata keep it."""
    has_data = data != nodata
    tgt = reach(idxs_ds, has_data)
    fill = (idxs_ds >= 0) & ~has_data & has_data[tgt]
    return torch.where(fill, data[tgt], data)


def fillnodata_downstream(idxs_ds, data, nodata, how="max"):
    """Fill nodata cells from upstream: each nodata cell takes the min, max
    or sum (``how``) over its nearest valid upstream cells, the first valid
    cell up each upstream path; a value travels down through nodata cells
    only. Nodata cells with no valid upstream cell keep nodata."""
    op = {"sum": "add"}.get(how, how)
    if op not in ("min", "max", "add"):
        raise ValueError(f'Unknown method: {how}, select from ["min", "max", "sum"].')
    n = idxs_ds.shape[0]
    ar = torch.arange(n, dtype=idxs_ds.dtype, device=idxs_ds.device)
    valid = idxs_ds >= 0
    has_data = valid & (data != nodata)
    was_nodata = valid & (data == nodata)
    send = valid & (idxs_ds != ar) & was_nodata[self_loop(idxs_ds)]
    ptr = torch.where(send, idxs_ds, torch.full_like(idxs_ds, n))
    ident = torch.full((), _identity(op, data.dtype), dtype=data.dtype, device=data.device)
    agg = _subtree_reduce(ptr, torch.where(has_data, data, ident), op)
    cnt = _subtree_reduce(ptr, has_data.to(torch.int32), "add")
    return torch.where(was_nodata & (cnt > 0), agg, data)


def propagate_downstream(idxs_ds, data):
    """``out[i] = data[idxs_ds[i]]``: one step downstream; missing cells keep
    their own value."""
    return data[self_loop(idxs_ds)]


# ---------------------------------------------------------------------------
# index sets, returned as host int64 arrays
# ---------------------------------------------------------------------------


def pit_indices(idxs_ds):
    """Cells with ``idxs_ds[i] == i`` (host)."""
    ids = np.asarray(idxs_ds)
    return np.flatnonzero(ids == np.arange(ids.size)).astype(np.int64)


def loop_indices(idxs_ds):
    """Cells on or above a cycle (``rank == -1``), from the device
    :func:`rank` of the tensor ``idxs_ds``."""
    return torch.nonzero(rank(idxs_ds) == -1).ravel().cpu().numpy()


def headwater_indices(idxs_ds, mask=None):
    """Cells with no upstream cell (inside ``mask``), from the device
    :func:`upstream_count`."""
    return torch.nonzero(upstream_count(idxs_ds, mask) == 0).ravel().cpu().numpy()


def confluence_indices(idxs_ds, mask=None):
    """Cells with two or more upstream cells (inside ``mask``), from the
    device :func:`upstream_count`."""
    return torch.nonzero(upstream_count(idxs_ds, mask) > 1).ravel().cpu().numpy()


def flwdir_tuples(idxs_ds, mask=None):
    """A ``[cell, downstream cell]`` int64 pair for every valid cell (with
    ``mask == 1``), a pit paired with itself (host)."""
    ids = np.asarray(idxs_ds, dtype=np.int64)
    keep = ids >= 0
    if mask is not None:
        keep = keep & (np.asarray(mask) == 1)
    return [np.array([i, ids[i]], dtype=np.int64) for i in np.flatnonzero(keep)]


def idxs_seq(idxs_ds, idxs_pit=None):
    """The cells that reach a pit (that reach one of ``idxs_pit``), downstream
    cells first: a stable sort of the device :func:`rank`, so each cell
    follows its downstream cell and equal ranks keep the order of their
    indices. Cells on or above a cycle and missing cells are left out."""
    r = rank(idxs_ds)
    valid = r >= 0
    if idxs_pit is not None:
        sel = torch.zeros(idxs_ds.shape[0], dtype=torch.bool, device=idxs_ds.device)
        sel[torch.as_tensor(np.asarray(idxs_pit), device=idxs_ds.device).long()] = True
        valid = valid & sel[roots(idxs_ds)]
    cells = torch.nonzero(valid).ravel()
    perm = torch.sort(r[cells], stable=True).indices
    return cells[perm].cpu().numpy()


def upstream_matrix(idxs_ds_np):
    """(n, d) int64 matrix whose row ``i`` lists the cells draining into
    ``i`` in ascending order, padded with -1; d is the largest fan-in
    (host)."""
    ids = np.asarray(idxs_ds_np, dtype=np.int64)
    n = ids.size
    ar = np.arange(n)
    is_child = (ids >= 0) & (ids != ar)
    children = ar[is_child]
    parents = ids[is_child]
    order = np.argsort(parents, kind="stable")
    children, parents = children[order], parents[order]
    counts = np.bincount(parents, minlength=n)
    d = int(counts.max()) if counts.size else 0
    out = np.full((n, max(d, 1)), -1, dtype=np.int64)
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out[parents, np.arange(children.size) - group_start[parents]] = children
    return out
