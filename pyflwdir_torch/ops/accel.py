"""Router accumulation plan for graphs of up to 2^21 cells (``AccelPlan``).

One accumulation of integer-valued float32 data is four kernel launches::

    c    = cumsum(x[sig_in])               # H1: cells -> preorder, prefix sum
    outp = c[near_end] - c[k-1]            # H2: near subtree sums (preorder)
    out  = outp[sig_out]                   # H0: preorder -> cells
    res  = tree ? out + c[far_end] : x     # H3: far interval ends, off-tree

The host build makes the same bijections and masks as the JAX package's
``ops/accel.py`` (``sig_in``, ``sig_out``, ``sig_exp``, ``sig_far``, the
near/far masks, ``b``, ``G``, ``n_pad`` and the ``ok`` rule), so the two
dispatch identically. Where the TPU routes ``sig_exp``, a lane broadcast
within b-blocks and ``sig_far`` as three chained permutations, the plan
composes them once into ``far_end``, the slot each far cell reads, and the
near-interval lane tables into ``near_end``.

Sums run in float32: exact only for integer-valued data with totals below
2^24, which ``Flwdir._accumulate_dev`` guarantees before it calls this.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .._backend import resolve_device
from .plan import DfsPlan, build_plan
from .router import RouterPlan

__all__ = ["AccelPlan", "build_accel_plan"]

_S = 128
_TILE = _S * _S  # elements per G-slice
_MAX_CELLS = 1 << 21


def _pad_bijection(dest_known, src_known, n_pad):
    """Extend a partial injective map dest->src to a bijection on [n_pad)."""
    sigma = np.full(n_pad, -1, dtype=np.int64)
    sigma[dest_known] = src_known
    used_src = np.zeros(n_pad, dtype=bool)
    used_src[src_known] = True
    free_src = np.nonzero(~used_src)[0]
    free_dst = np.nonzero(sigma < 0)[0]
    sigma[free_dst] = free_src
    return sigma


class AccelPlan:
    """Per-graph plan for router accumulation (``ok`` False: does not fit)."""

    def __init__(self, dfs: DfsPlan, device=None):
        self.device = resolve_device(device)
        pre = dfs.preorder_np
        pos = dfs.pos_np
        size = dfs.size_np
        n_cells = pos.size
        n_tree = pre.size
        self.n_cells = n_cells
        self.n_tree = n_tree

        k = np.arange(n_tree, dtype=np.int64)
        d = size[pre] - 1
        e = k + d
        far = d >= _S

        # distinct far interval ends and the slot block size
        uniq_e, inv = np.unique(e[far], return_inverse=True)
        D = uniq_e.size
        if D:
            counts = np.bincount(inv)
            b = min(max(1 << int(int(counts.max() - 1).bit_length()), 1), _S)
        else:
            b = 1
        self.ok = D * b <= _S**3 and (not D or int(counts.max()) <= _S)
        n_pad = max(n_cells, n_tree, D * b)
        n_pad = -(-n_pad // _TILE) * _TILE
        G = n_pad // _TILE
        self.ok = self.ok and G <= _S
        if not self.ok:
            return
        self.n_pad = n_pad
        self.G = G
        self.b = b
        self.has_far = D > 0

        # R_in: preorder slot k <- cell pre[k]
        self.sig_in = _pad_bijection(k, pre, n_pad)
        # R_out: cell i <- preorder slot pos[i]
        on_tree = np.nonzero(pos >= 0)[0]
        self.sig_out = _pad_bijection(on_tree, pos[on_tree], n_pad)

        # near-interval lane tables (preorder layout), as the JAX plan has them
        lane = k % _S
        self.near_mask = np.zeros(n_pad, dtype=np.float32)
        self.near_mask[k[~far]] = 1.0
        self.idx_near = np.zeros(n_pad, dtype=np.int8)
        self.sel_next = np.zeros(n_pad, dtype=bool)
        ln = lane + np.where(far, 0, d)
        self.idx_near[:n_tree] = (ln % _S).astype(np.int8)
        self.sel_next[:n_tree] = ln >= _S
        self.tree_mask = np.zeros(n_pad, dtype=bool)
        self.tree_mask[:n_cells] = pos >= 0
        self.far_mask = np.zeros(n_pad, dtype=np.float32)

        if self.has_far:
            # R_exp: slot b*j <- preorder position uniq_e[j]
            slots = np.arange(D, dtype=np.int64) * b
            self.sig_exp = _pad_bijection(slots, uniq_e, n_pad)
            # R_far: cell pre[k] <- slot b*group(k) + rank-in-group
            k_far = k[far]
            order = np.argsort(inv, kind="stable")
            ranks = np.empty(k_far.size, dtype=np.int64)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            ranks[order] = np.arange(k_far.size) - np.repeat(starts, counts)
            self.sig_far = _pad_bijection(pre[k_far], inv * b + ranks, n_pad)
            self.far_mask[pre[k_far]] = 1.0

        # -- compose the tables into the indices the kernels read ---------
        slot = np.arange(n_pad, dtype=np.int64)
        row_end = (slot // _S + self.sel_next) * _S + self.idx_near
        near_end = np.where(self.near_mask != 0, row_end, -1)
        far_end = np.where(self.tree_mask, -1, -2)[:n_cells]
        if self.has_far:
            cells = np.nonzero(self.far_mask[:n_cells])[0]
            blk = (self.sig_far[cells] // b) * b  # the lane broadcast
            far_end[cells] = self.sig_exp[blk]
        dev = self.device
        self.sig_in_t = torch.as_tensor(self.sig_in.astype(np.int32), device=dev)
        self.near_end_t = torch.as_tensor(near_end.astype(np.int32), device=dev)
        self.far_end_t = torch.as_tensor(far_end.astype(np.int32), device=dev)
        self.r_out = RouterPlan(self.sig_out, device=dev)

    def accumulate(self, data):
        """Flow accumulation of ``data`` ((n_cells,) tensor on the plan's
        device): tree cells get their subtree sum, off-tree cells pass
        through. Computed in float32 and returned in ``data``'s dtype."""
        x = data.to(torch.float32).contiguous()
        c = kernels.accel_in_scan(x, self.sig_in_t)
        outp = kernels.accel_near_out(c, self.near_end_t)
        out = self.r_out.apply(outp.reshape(self.G * _S, _S)).reshape(-1)
        res = kernels.accel_far_merge(out, x, c, self.far_end_t)
        return res.to(data.dtype)


def build_accel_plan(idxs_ds_np, dfs: DfsPlan = None, device=None) -> AccelPlan:
    """Build the single-chunk router plan for a graph.

    Where the JAX package would fall back to its HBM-scale ``BigAccelPlan``
    (the plan does not fit, or more than 2^21 cells), this raises
    NotImplementedError: that engine belongs to a later slice of the port.
    """
    idxs_ds_np = np.asarray(idxs_ds_np)
    if dfs is None:
        dfs = build_plan(idxs_ds_np, device=device)
    plan = AccelPlan(dfs, device=device if device is not None else dfs.device)
    if not plan.ok or plan.n_cells > _MAX_CELLS:
        raise NotImplementedError(
            "graph does not fit the single-chunk AccelPlan; the HBM-scale "
            "BigAccelPlan (ops/accel_big.py) is queued for a later slice of the port"
        )
    return plan
