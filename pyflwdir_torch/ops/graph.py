"""Flow-graph primitives by pointer doubling, in plain PyTorch.

Data contract: ``idxs_ds`` is a 1-D int64 tensor of next-downstream
indices; ``idxs_ds[i] == i`` marks a pit, ``-1`` a missing cell. Each
doubling round is a whole-array gather; the loop stops when the pointers
converge, and after at most ``ceil(log2 n) + 1`` rounds.
"""

from __future__ import annotations

import math

import torch

__all__ = ["self_loop", "valid_mask", "pit_mask", "rank", "roots", "reach"]


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
