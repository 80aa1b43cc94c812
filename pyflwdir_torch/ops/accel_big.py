"""Router accumulation past the single-chunk plan: ``BigAccelPlan``.

The same DFS-interval identity as ``ops/accel.py`` (subtree sums are
differences of one prefix sum over the DFS preorder) for graphs of up to
128 * 2^21 = 2^28 padded slots: the 1-D engine of a graph past 2^21 cells
(or one whose far groups do not fit ``AccelPlan``) and, in slot mode, the
tile plan's coarse level past its single-chunk router, upward and downward.

The JAX package's ``BigAccelPlan`` (``ops/accel_big.py``) moves the data
through 7-stage routers (``r_in``, ``r_out``, ``r_exp``, ``r_far``; ``r_es``,
``r_dea``, ``r_deb`` and two inverses downward), a pair of lane gathers for
the near interval ends and a dense group expansion for the far ones, because
the TPU has no fast gather. The port makes that class's decisions (``n_in``,
``n_out``, ``n_pad`` rounded up to 2^21, ``G1``, ``ok``, ``slot_mode``, the
near/far split at a span of 128, ``has_far``) and keeps what its tables
compose to: the four host indices of
:class:`pyflwdir_torch.ops.accel.IntervalKernels`, uploaded as the three of
kernels H1, H2 and H3, and, downward, the six of :class:`CoarseDown`
(kernels H1 and H0). The native build takes them from the DFS plan directly;
``routers=`` takes a JAX plan's ``router_tables()`` and replays its chains on
``arange`` into the same indices.

Data sums in the dtype of the port's rule
(:func:`pyflwdir_torch.kernels.sum_dtype`; the JAX class sums int32 and a
double-single float32 pair, for want of float64 on the TPU), chosen in slot
mode by the caller (the tile plan).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, trace
from .._backend import resolve_device
from .accel import IntervalKernels, _pad_bijection
from .plan import DfsPlan, build_plan
from .router_big import router_sigma

__all__ = ["BigAccelPlan", "CoarseDown", "RouterAccel", "build_big_accel_plan",
           "down_sort_sigmas"]

_S = 128
_CHUNK = _S * _S * _S  # elements per router chunk (2^21)


def down_sort_sigmas(pre, size, n_pad, need_sigmas=True):
    """The (interval end, slot) sort of the downward solve and its run
    boundaries, as the JAX package's ``down_sort_sigmas``: returns
    ``(sig_es, sig_dea, sig_deb, de_sel, de_b0)``. ``sig_es[j]`` is the slot
    at sorted position j; at an end slot e (``de_sel``) ``sig_dea[e]`` is the
    sorted position of its run's last member and ``sig_deb[e]`` of the member
    before its run (none for the first run, ``de_b0``); all three padded to
    bijections on ``[0, n_pad)``. The sigmas are None where not
    ``need_sigmas`` (they then come from a JAX plan's routers)."""
    n_tree = pre.size
    k = np.arange(n_tree, dtype=np.int64)
    ends = k + size[pre] - 1
    de_sel = np.zeros(n_pad, dtype=bool)
    de_b0 = np.zeros(n_pad, dtype=bool)
    if n_tree:
        de_sel[ends] = True
        de_b0[ends.min()] = True
    if not need_sigmas:
        return None, None, None, de_sel, de_b0
    order = np.argsort(ends, kind="stable")  # (end, slot) order
    sig_es = _pad_bijection(k, order, n_pad)
    e_sorted = ends[order]
    gstart = np.flatnonzero(np.r_[True, e_sorted[1:] != e_sorted[:-1]][:n_tree])
    glast = np.append(gstart[1:] - 1, n_tree - 1) if n_tree else gstart
    gend = e_sorted[gstart]
    sig_dea = _pad_bijection(gend, glast, n_pad)
    sig_deb = _pad_bijection(gend[1:], gstart[1:] - 1, n_pad)
    return sig_es, sig_dea, sig_deb, de_sel, de_b0


def _far_replay(k_far, d_far, dst_far, sig_exp, sig_far):
    """Replay the JAX router plans' far values (``_far_values``): ``sig_exp``
    routes the distinct interval ends into a packed group array (None: tables
    from before ``r_exp``, which gathered them), a row-pair lane gather
    copies each to its duplicates, ``sig_far`` delivers them. Far nodes
    ``k_far`` span ``d_far`` slots and write outputs ``dst_far``; returns
    (those outputs, sorted; the end each reads)."""
    e_far = k_far + d_far
    order = np.lexsort((k_far, e_far))
    uniq_e, inv = np.unique(e_far[order], return_inverse=True)
    if sig_exp is None:
        sig_exp = uniq_e
    F = k_far.size
    d_rows = -(-uniq_e.size // _S)
    f_rows = -(-F // _S)
    # the last far row is padded with the last group
    g = np.full(f_rows * _S, inv[-1], dtype=np.int64)
    g[:F] = inv
    g = g.reshape(f_rows, _S)
    rlo = g.min(axis=1) // _S
    bidx = g - (rlo * _S)[:, None]
    if bidx.max() >= 2 * _S:
        raise AssertionError("far group rows span more than a row pair")
    # packed value of far slot q: row rlo (+1 where bidx_hi, clipped to the
    # last distinct-end row) of the routed ends, lane bidx
    cells = np.sort(dst_far)
    q = sig_far[cells]
    ok = q < f_rows * _S
    r, lq = q[ok] // _S, q[ok] % _S
    row = np.where(bidx[r, lq] >= _S, np.minimum(rlo[r] + 1, d_rows - 1), rlo[r])
    fe = np.full(cells.size, -1, dtype=np.int64)
    fe[ok] = sig_exp[row * _S + bidx[r, lq] % _S]
    return cells, fe


# ---------------------------------------------------------------------------
# the downward (transpose) solve in slot mode: the tile plan's coarse level
# ---------------------------------------------------------------------------
class CoarseDown:
    """The coarse forest's inclusive downstream-path sum, from the packed
    entry (``out_slot``) layout to the exit (``in_slot``) layout, zero at
    slots without a root: the transpose of the class's ``accumulate``.

    The JAX package's router coarse levels (``_CoarseRouterSmall`` and
    ``BigAccelPlan`` ``accumulate_down``) route through ``r_win``, ``r_es``,
    ``r_dea``, ``r_deb`` and ``r_aout`` with mask selects between flat prefix,
    shift and suffix sums (its ``_CoarseGather`` level scatter-adds instead).
    The port keeps what those compose to over ``n_c`` slots (``_n_down``), as
    indices of kernels H1 and H0:

    * ``es_in`` (H1): the packed entry read at each position of the
      (interval end, slot) order; nodes without an entry read past the input;
    * ``g_last``, ``g_prev`` (H0): per end slot, the sorted position of its
      run's last node and of the node before its run, else -1 (reads 0);
    * ``win_next`` (H0): the packed entry of the next preorder slot, else -1;
    * ``rev`` (H1): the reversal, so the suffix sum is a prefix sum;
    * ``fin`` (H0): per exit slot, its root's position in the reversed sums.

    One form for every backend: each sum has a fixed order (no atomics).
    A subclass holds the coarse DFS plan as ``dfs``."""

    def build_down(self, dfs, routers=None):
        """Build the down indices from the coarse DFS plan ``dfs``, as the
        JAX call does, with the plan's own slot maps; or from the
        coarse-downward arrays (a mapping: ``pre``, ``pos`` of the coarse DFS
        plan, ``e2n``, the root node of each exit slot or -1, and ``wmap``,
        the ``out_slot`` of each node; a JAX plan's ``_down["cd"]``). For a
        router coarse level loaded from a JAX plan, ``routers`` takes its
        ``down_router_tables()``, whose chains are replayed instead of
        sorting here, or the port's, which hold the composed indices."""
        if getattr(self, "down", None) is not None:
            return
        if routers is not None and "es_in" in routers:
            if routers["es_in"].size != self._n_down(self.dfs.n_tree):
                raise ValueError("down router tables do not fit the coarse plan")
            self.set_down(routers)
            return
        cd = self._down_maps(dfs) if isinstance(dfs, DfsPlan) else dfs
        pre = np.asarray(cd["pre"], np.int64)
        pos = np.asarray(cd["pos"], np.int64)
        e2n = np.asarray(cd["e2n"], np.int64)
        k = pre.size
        n_c = self._n_down(k)
        win = np.asarray(cd["wmap"], np.int64)[pre]  # packed entry of each slot
        sig_es, sig_dea, sig_deb, de_sel, de_b0 = down_sort_sigmas(
            pre, self.dfs.size_np, n_c, need_sigmas=routers is None)
        if routers is not None:
            sig_es, sig_dea, sig_deb = (router_sigma(routers, name)
                                        for name in ("r_es", "r_dea", "r_deb"))
            if sig_es.size != n_c:
                raise ValueError("down router tables do not fit the coarse plan")
        order = sig_es[:k]
        es_in = np.full(n_c, n_c, dtype=np.int64)
        es_in[:k] = np.where(win[order] >= 0, win[order], n_c)
        win_next = np.full(n_c, -1, dtype=np.int64)
        win_next[: max(k - 1, 0)] = win[1:]
        root_pos = np.where(e2n >= 0, pos[np.maximum(e2n, 0)], -1)
        down = {"es_in": es_in,
                "g_last": np.where(de_sel, sig_dea, -1),
                "g_prev": np.where(de_sel & ~de_b0, sig_deb, -1),
                "win_next": win_next,
                "rev": np.arange(n_c - 1, -1, -1, dtype=np.int64),
                "fin": np.where(root_pos >= 0, n_c - 1 - root_pos, -1)}
        self.set_down(down)

    def set_down(self, down):
        """Keep the composed down indices (as :meth:`build_down` makes them,
        or as a saved plan holds them) as int32 and upload them."""
        self.down = {name: np.asarray(v).astype(np.int32) for name, v in down.items()}
        with trace.span("plan.down.upload"):
            self._down_t = {name: torch.as_tensor(v, device=self.dfs.device)
                            for name, v in self.down.items()}

    def down_arrays(self):
        """The downward sweep's device tables, for the ``arrs`` argument of
        :meth:`accumulate_down` (after :meth:`build_down`)."""
        return self._down_t

    def accumulate_down(self, pkf, arrs=None):
        """``pkf`` ((n_out,) at ``out_slot`` layout; int32, int64 or float64)
        to the path sums at ``in_slot`` layout, one per exit slot. ``arrs``:
        the tables of :meth:`down_arrays` (None: the plan's own)."""
        t = self._down_t if arrs is None else arrs
        pkf = pkf[: t["es_in"].numel()]  # padded entries past the last real one
        cs = kernels.accel_in_scan(pkf, t["es_in"])
        ge = kernels.permute_gather(cs, t["g_last"]) - kernels.permute_gather(cs, t["g_prev"])
        inner = ge - kernels.permute_gather(pkf, t["win_next"])
        return kernels.permute_gather(kernels.accel_in_scan(inner, t["rev"]), t["fin"])


# ---------------------------------------------------------------------------
# upward: what the single-chunk and the chunked router plans share
# ---------------------------------------------------------------------------
class RouterAccel(IntervalKernels, CoarseDown):
    """The router plans' accumulation over ``n_pad`` padded preorder slots,
    from a DFS plan and optional slot maps. :class:`BigAccelPlan` and the
    tile plan's ``_CoarseRouterSmall`` differ in the pad unit, the capacity,
    how ``n_in`` is found and which stage tables ``routers`` holds.

    In slot mode the input value of node i lives at flat slot ``in_slot[i]``
    and its sum is delivered to slot ``out_slot[i]`` (< 0: not needed); slots
    without a value give 0 and there is no pass-through. A caller that
    states ``n_in`` (the single-chunk plan) has nodes whose ``in_slot`` lies
    at or past it read 0; where it is inferred from ``in_slot`` they read
    whatever input lies there, 0 past its end."""

    def _build(self, dfs, in_slot, out_slot, n_in, unit, cap, routers):
        self.dfs = dfs
        pre, pos, size = dfs.preorder_np, dfs.pos_np, dfs.size_np
        n_cells, n_tree = pos.size, pre.size
        self.n_cells, self.n_tree = n_cells, n_tree
        self.slot_mode = in_slot is not None or out_slot is not None
        if in_slot is not None:
            in_slot = np.asarray(in_slot, dtype=np.int64)
        if out_slot is not None:
            out_slot = np.asarray(out_slot, dtype=np.int64)
        self._slots = in_slot, out_slot
        mask_in = n_in
        if n_in is None:
            n_in = n_cells if in_slot is None else int(in_slot.max() + 1 if in_slot.size else 1)
        self.n_in = int(n_in)
        self.n_out = n_out = (n_cells if out_slot is None
                              else int(out_slot.max() + 1 if out_slot.size else 1))
        n_pad = -(-max(n_cells, n_tree, self.n_in, n_out, 1) // unit) * unit
        self.ok = n_pad <= cap
        if not self.ok:
            return
        self.n_pad = n_pad

        k = np.arange(n_tree, dtype=np.int64)
        d = size[pre] - 1  # interval k .. k + d
        near = d < _S
        near_end = np.full(n_pad, -1, dtype=np.int32)
        near_end[:n_tree][near] = (k + d)[near]
        # padding slots read past any input (H1 gives 0 at source n_pad)
        src = pre if in_slot is None else in_slot[pre]
        has_in = np.ones(n_tree, bool) if mask_in is None else src < mask_in
        # the output each tree node writes; off-tree outputs pass the input
        # through or give 0 (far_end -2), whatever src_out holds there
        dst = pre if out_slot is None else out_slot[pre]
        has_out = dst >= 0
        far_end = np.full(n_out, -2, dtype=np.int32)
        far_end[dst[has_out]] = -1
        far = ~near & has_out
        self.has_far = bool(far.any())
        if routers is not None and "src_in" in routers:  # the port's router_tables()
            if routers["src_in"].size != n_pad or routers["far_end"].size != n_out:
                raise ValueError("router tables do not fit the plan")
            self._set_indices(dfs.device, **{k: routers[k] for k in self._INDICES})
            return
        src_in = np.full(n_pad, n_pad, dtype=np.int32)
        src_out = np.zeros(n_out, dtype=np.int32)
        if routers is None:
            src_in[:n_tree][has_in] = src[has_in]
            src_out[dst[has_out]] = k[has_out]
            far_end[dst[far]] = (k + d)[far]
        else:
            sig_in = router_sigma(routers, "r_in")
            if sig_in.size != n_pad:
                raise ValueError("router tables do not fit the plan")
            src_in[:n_tree][has_in] = sig_in[:n_tree][has_in]
            if "r_out" in routers:
                sig_out = router_sigma(routers, "r_out")
            else:  # default mode: pos inverts pre
                sig_out = np.empty_like(sig_in)
                sig_out[sig_in] = np.arange(n_pad, dtype=np.int64)
            src_out = np.where(far_end != -2, sig_out[:n_out], 0)
            del sig_in, sig_out
            if self.has_far:
                sig_exp = router_sigma(routers, "r_exp") if "r_exp" in routers else None
                cells, fe = _far_replay(k[far], d[far], dst[far], sig_exp,
                                        router_sigma(routers, "r_far"))
                far_end[cells] = fe
        self._set_indices(dfs.device, src_in=src_in, near_end=near_end,
                          src_out=src_out, far_end=far_end)

    def _n_down(self, k):
        return self.n_pad

    def _down_maps(self, dfs):
        """The coarse-downward arrays of :meth:`build_down` from the coarse
        DFS plan and the slot maps (slot mode): ``e2n`` over ``n_pad`` exit
        slots."""
        in_slot, out_slot = self._slots
        if in_slot is None or out_slot is None:
            raise ValueError("the downward sweep needs a plan in slot mode")
        e2n = np.full(self.n_pad, -1, dtype=np.int64)
        e2n[in_slot] = np.arange(in_slot.size)
        return {"pre": dfs.preorder_np, "pos": dfs.pos_np, "e2n": e2n, "wmap": out_slot}

    def router_tables(self):
        """The upward tables, for saving, as the JAX call returns its routers'
        stage tables: here the composed indices ``src_in``, ``near_end``,
        ``src_out`` and ``far_end``, which ``routers=`` takes back as they
        are."""
        return {name: getattr(self, name) for name in self._INDICES}

    def down_router_tables(self):
        """The downward tables, for saving (after :meth:`build_down`): the
        composed indices of :attr:`down`, which ``build_down(dfs, routers=)``
        takes back as they are."""
        return dict(self.down)

    def accumulate(self, data, arrs=None):
        """Flow accumulation of ``data`` (a 1-D tensor on the plan's device)
        in three kernel launches. Default mode: ``data`` (n_cells,) of any
        dtype, summed in :func:`~pyflwdir_torch.kernels.sum_dtype`'s dtype
        and returned in its own; tree
        cells get their subtree sum, off-tree cells pass through. Slot mode:
        ``data`` at ``in_slot`` layout in int32, int64 or float64 (shorter
        than ``n_in``: the rest reads 0), the result (n_out,) at
        ``out_slot`` layout, 0 at slots without a value.
        ``arrs``: the tables of :meth:`arrays` (None: the plan's own)."""
        if self.slot_mode:
            return self._sweep(data.contiguous(), passthrough=False, arrs=arrs)
        if data.numel() != self.n_cells:
            raise ValueError(f"data must hold {self.n_cells} values")
        with trace.span("up"):
            x = kernels.cast_in(data, "up", kernels._SUM_DTYPES)
            out = self._sweep(x, passthrough=True, arrs=arrs)
            return kernels.cast_back(out, data.dtype, "up")


class BigAccelPlan(RouterAccel):
    """Per-graph plan for router accumulation of up to 128 * 2^21 padded
    slots (``ok`` False: more). ``routers`` takes a JAX ``BigAccelPlan``'s
    ``router_tables()`` (keyed ``"G1"``; ``r_out`` absent in default mode,
    ``r_exp`` absent in old tables), whose chains are replayed instead of
    composing the indices here; ``build_down`` its ``down_router_tables()``.
    Both also take the port's own :meth:`router_tables` /
    :meth:`down_router_tables`, the composed indices.

    ``n_in`` is found as the JAX class finds it (``in_slot.max() + 1``, the
    tile plan's zero slots of its entry nodes included), so ``n_pad`` and
    ``G1`` agree with it; the caller hands over its real input only, and a
    slot past that reads 0. ``idxs_ds_np`` is unused, as there."""

    def __init__(self, dfs: DfsPlan, idxs_ds_np, routers=None, in_slot=None,
                 out_slot=None, device=None):
        self.device = dfs.device  # the indices live where the DFS plan does
        if device is not None and resolve_device(device).type != self.device.type:
            raise ValueError(f"the DFS plan lies on {self.device}, not on {device}")
        self._build(dfs, in_slot, out_slot, None, _CHUNK, _S * _CHUNK, routers)
        if self.ok:
            self.G1 = self.n_pad // _CHUNK


def build_big_accel_plan(idxs_ds_np, dfs: DfsPlan = None, routers=None, device=None):
    """Build a :class:`BigAccelPlan`; None if the graph exceeds 128 * 2^21
    cells."""
    idxs_ds_np = np.asarray(idxs_ds_np)
    if dfs is None:
        dfs = build_plan(idxs_ds_np, device=device)
    with trace.span("plan.big"):
        plan = BigAccelPlan(dfs, idxs_ds_np, routers=routers, device=device)
    return plan if plan.ok else None
