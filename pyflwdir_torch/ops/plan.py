"""Euler-tour (DFS interval) accumulation plan.

Under a DFS preorder of the flow forest every subtree is a contiguous
interval ``[pos[i], pos[i] + size[i])``, so flow accumulation is one
prefix sum and two gathers::

    c    = cumsum(data[preorder])
    accu = c[pos + size - 1] - c[pos - 1]

The preorder is built once per graph on the host (the native
``dfs_preorder``); the plan keeps int64 copies on the host and on its
device. Sums run in int64 for integer data and float64 for float data, on
the CPU and the GPU alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .._backend import resolve_device

__all__ = ["DfsPlan", "build_plan", "accumulate_planned", "accumulate_planned_fast"]


class DfsPlan:
    """DFS-interval plan for a fixed flow graph.

    Attributes
    ----------
    preorder_np : (k,) int64 — tree cells in DFS preorder
    pos_np : (n,) int64 — position of each cell in preorder, -1 off-tree
    size_np : (n,) int64 — subtree size (0 off-tree)
    preorder, pos, size : the same as tensors on ``device``

    ``fast`` is taken and ignored: the JAX package skips its fast-kernel
    tables with it; here the one table of :func:`accumulate_planned_fast`,
    ``end``, is always built.
    """

    def __init__(self, preorder, pos, size, fast=True, device=None):
        self.device = resolve_device(device)
        self.preorder_np = np.asarray(preorder, dtype=np.int64)
        self.pos_np = np.asarray(pos, dtype=np.int64)
        self.size_np = np.asarray(size, dtype=np.int64)
        self.n_tree = int(self.preorder_np.shape[0])
        with trace.span("plan.upload"):
            self.preorder = torch.as_tensor(self.preorder_np, device=self.device)
            self.pos = torch.as_tensor(self.pos_np, device=self.device)
            self.size = torch.as_tensor(self.size_np, device=self.device)
        # preorder position of each slot's interval end, k + size[pre[k]] - 1
        self.end = torch.arange(self.n_tree, device=self.device) + self.size[self.preorder] - 1

    def fast(self):
        """The device table of :func:`accumulate_planned_fast`: each preorder
        slot's interval end (the JAX package returns its fast-kernel tables)."""
        return self.end


def build_plan(idxs_ds_np, fast=True, device=None) -> DfsPlan:
    """Build the DFS plan for a graph with the native preorder builder
    (``fast`` ignored, as in :class:`DfsPlan`)."""
    from ..runtime import dfs_preorder

    with trace.span("plan.dfs"):
        return DfsPlan(*dfs_preorder(np.asarray(idxs_ds_np)), device=device)


def _acc_dtype(dtype):
    """int64 for integer and bool data, float64 for float data."""
    if dtype.is_floating_point:
        return torch.float64
    return torch.int64


def accumulate_planned(plan: DfsPlan, data: torch.Tensor) -> torch.Tensor:
    """Flow accumulation through the DFS-interval plan.

    ``out[i] = sum(data[j] for j in subtree(i))`` for tree cells; off-tree
    cells return ``data`` unchanged. Exact for integer data.
    """
    if plan.n_tree == 0:
        return data
    acc = _acc_dtype(data.dtype)
    c = torch.cumsum(data[plan.preorder].to(acc), 0)
    e_idx = (plan.pos + plan.size - 1).clamp(0, plan.n_tree - 1)
    s_idx = (plan.pos - 1).clamp(0, plan.n_tree - 1)
    zero = torch.zeros((), dtype=acc, device=c.device)
    out = c[e_idx] - torch.where(plan.pos > 0, c[s_idx], zero)
    return torch.where(plan.pos >= 0, out.to(data.dtype), data)


def accumulate_planned_fast(plan: DfsPlan, data: torch.Tensor) -> torch.Tensor:
    """The same function as :func:`accumulate_planned`, computed in
    preorder layout: gather to preorder, prefix sum, interval ends by one
    gather, starts by a shift, scatter back to cells. Off-tree cells keep
    their input values."""
    if plan.n_tree == 0:
        return data
    acc = _acc_dtype(data.dtype)
    c = torch.cumsum(data[plan.preorder].to(acc), 0)
    prev = torch.cat([torch.zeros(1, dtype=acc, device=c.device), c[:-1]])
    out = data.to(acc, copy=True)
    out[plan.preorder] = c[plan.end] - prev
    return out.to(data.dtype)
