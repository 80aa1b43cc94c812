"""Router accumulation plan for graphs of up to 2^21 cells (``AccelPlan``).

One accumulation of integer-valued float32 data is three kernel launches::

    c    = cumsum(x[src_in])               # H1: cells -> preorder, prefix sum
    outp = c[end] - c[k-1]                 # H2: subtree sums (preorder)
    res  = tree ? outp[src_res] : x        # H3: preorder -> cells, off-tree

(:class:`IntervalKernels`, which the large-graph ``BigAccelPlan`` of
``ops/accel_big.py`` and the tile plan's router coarse level run too). The
host build makes the same bijections and masks as the JAX package's
``ops/accel.py`` (``sig_in``, ``sig_out``, ``sig_exp``, ``sig_far``, the
near/far masks, ``b``, ``G``, ``n_pad`` and the ``ok`` rule), so the two
dispatch identically. Where the TPU routes ``sig_exp``, a lane broadcast
within b-blocks and ``sig_far`` as three chained permutations, because its
lane gather reaches only 128 lanes, the plan composes them once into
``far_end``, the slot each far cell reads, and the near-interval lane
tables into ``near_end``; the kernels read both as one interval end per
preorder slot.

Sums run in float32: exact only for integer-valued data with totals below
2^24, which ``Flwdir._accumulate_dev`` guarantees before it calls this.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, trace
from .._backend import resolve_device
from .plan import DfsPlan, build_plan

__all__ = ["AccelPlan", "IntervalKernels", "build_accel_plan"]

_S = 128
_TILE = _S * _S  # elements per G-slice


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


class IntervalKernels:
    """The DFS-interval accumulation as the three kernels run it. Every
    router plan composes its tables into four int32 host indices:

    * ``src_in`` (n_pad,): the input element each preorder slot reads; a
      source at or past the input's length reads 0;
    * ``near_end`` (n_pad,): the slot where a near interval (span < 128)
      ends, -1 for far intervals and padding;
    * ``src_out`` (>= n_out,): the preorder slot each output element reads;
    * ``far_end`` (n_out,): the slot where an output's far interval ends, -1
      for other tree outputs, -2 off the tree;

    and uploads three: ``src_in`` (H1); ``end`` (n_pad,), every tree slot's
    interval end, ``near_end`` with each far end carried back to its slot
    through ``src_out`` (-1 for padding and for far slots no output reads;
    H2); ``src_res`` (n_out,), ``src_out`` on the tree and -1 off it (H3).
    """

    _INDICES = ("src_in", "near_end", "src_out", "far_end")

    def _set_indices(self, device, **idx):
        """Keep the indices as numpy int32 attributes; compose and upload
        the kernels' three."""
        for name in self._INDICES:
            setattr(self, name, np.ascontiguousarray(idx[name], dtype=np.int32))
        n_out = self.far_end.size
        src_out = self.src_out[:n_out]
        far = self.far_end >= 0
        end = self.near_end.copy()
        end[src_out[far]] = self.far_end[far]
        src_res = np.where(self.far_end != -2, src_out, -1).astype(np.int32)
        with trace.span("plan.upload"):
            self._t = {name: torch.as_tensor(arr, device=device)
                       for name, arr in (("src_in", self.src_in), ("end", end),
                                         ("src_res", src_res))}

    def arrays(self):
        """The kernels' device tables (``src_in``, ``end``, ``src_res``), for
        the ``arrs`` argument of ``accumulate``, as the JAX package's plans
        hand theirs to a jitted call."""
        return self._t

    def _sweep(self, x, passthrough, arrs=None):
        """``x`` (1-D; float32, int32, int64 or float64) to its subtree sums
        in the output layout; off-tree outputs pass ``x`` through (the two
        layouts are then one) or give 0. ``arrs``: the tables of
        :meth:`arrays` (None: the plan's own)."""
        t = self._t if arrs is None else arrs
        with trace.span("H1"):
            c = kernels.accel_in_scan(x, t["src_in"])
        with trace.span("H2"):
            outp = kernels.accel_near_out(c, t["end"])
        with trace.span("H3"):
            return kernels.accel_far_merge(outp, x if passthrough else None, t["src_res"])


class AccelPlan(IntervalKernels):
    """Per-graph plan for router accumulation (``ok`` False: does not fit)."""

    def __init__(self, dfs: DfsPlan, idxs_ds_np, device=None):
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
        self._set_indices(self.device, src_in=self.sig_in, near_end=near_end,
                          src_out=self.sig_out, far_end=far_end)

    def accumulate(self, data):
        """Flow accumulation of ``data`` ((n_cells,) tensor on the plan's
        device): tree cells get their subtree sum, off-tree cells pass
        through. Computed in float32 and returned in ``data``'s dtype."""
        x = data.to(torch.float32).contiguous()
        return self._sweep(x, passthrough=True).to(data.dtype)


def build_accel_plan(idxs_ds_np, dfs: DfsPlan = None, routers=None, device=None):
    """Build the router accumulation plan for a graph, as the JAX package's
    ``build_accel_plan``: the single-chunk :class:`AccelPlan` where the graph
    fits it, else the large-graph
    :class:`pyflwdir_torch.ops.accel_big.BigAccelPlan` (up to 128 * 2^21
    cells; ``routers`` takes a JAX plan's ``router_tables()``), else None.
    """
    idxs_ds_np = np.asarray(idxs_ds_np)
    if dfs is None:
        dfs = build_plan(idxs_ds_np, device=device)
    device = device if device is not None else dfs.device
    with trace.span("plan.accel"):
        plan = AccelPlan(dfs, idxs_ds_np, device=device)
    if plan.ok:
        return plan
    from .accel_big import build_big_accel_plan

    return build_big_accel_plan(idxs_ds_np, dfs, routers=routers, device=device)
