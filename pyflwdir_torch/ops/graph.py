"""Flow-graph primitives by pointer doubling, in plain PyTorch.

Data contract: ``idxs_ds`` is a 1-D int64 tensor of next-downstream
indices; ``idxs_ds[i] == i`` marks a pit, ``-1`` a missing cell. Each
doubling round is a whole-array gather; the loop stops when the pointers
converge, and after at most ``ceil(log2 n) + 1`` rounds.
"""

from __future__ import annotations

import math

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
    "accumulate_downstream",
    "fillnodata_upstream",
    "propagate_downstream",
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


def fillnodata_upstream(idxs_ds, data, nodata):
    """Fill nodata cells with the first valid value downstream; cells whose
    whole downstream path is nodata keep it."""
    has_data = data != nodata
    tgt = reach(idxs_ds, has_data)
    fill = (idxs_ds >= 0) & ~has_data & has_data[tgt]
    return torch.where(fill, data[tgt], data)


def propagate_downstream(idxs_ds, data):
    """``out[i] = data[idxs_ds[i]]``: one step downstream; missing cells keep
    their own value."""
    return data[self_loop(idxs_ds)]
