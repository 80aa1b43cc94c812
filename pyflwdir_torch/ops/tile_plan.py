"""Hierarchical tile plan: flow accumulation of rasters above 2^21 cells.

The raster is cut into 128 x 128 tiles. The flow graph inside a
tile is a forest whose roots are pits and tile-exit cells; each tile gets a
DFS preorder of its own, so every local subtree is a preorder interval and
its sum a difference of two prefix sums. One accumulation is three steps,
as in the JAX package's ``TilePlan.accumulate`` (fused A -> C)::

    exits, c = tile_pass_a(x)            # T1: per-tile prefix sums, root sums
    entries  = coarse.accumulate(exits)  # root -> entry graph, ~n/100 nodes
    out      = tile_pass_c(x, c, entries)  # T2: inject inflows, differences

The coarse level is the same slot-mode accumulation as the JAX package's:
plain gathers through the DFS plan below ``_COARSE_ROUTER_MIN`` slots
(``_CoarseGather``), else the single-chunk router (``_CoarseRouterSmall``,
kernels H0-H3) up to ``_COARSE_SMALL_MAX`` slots. Above that the JAX package
takes ``BigAccelPlan``, which the port does not have yet: the build raises
NotImplementedError.

The host build makes the JAX build's decisions (the phase-1 DFS, the far
mode and ``b``, ``R_pad``, ``E_pad``, the coarse graph and its slots, the
coarse backend thresholds), so the two dispatch identically. Where the JAX
plan keeps 5-stage int8 router tables per family, the port keeps one int32
index per slot (``rin``, ``rout``, ``ex_end``, ``near_end``, ``far_end``,
``ent_idx``, each relative to its tile), what each chain composes to; the
native build takes them from phase 1 directly (the far mode and ``b`` say
only how the TPU routers deliver the far ends). :meth:`TilePlan.from_stage_tables`
builds the same indices from a JAX plan's tables by replaying the chains on
``arange``.

Tiles are 128 rows high, the one height the CUDA kernels take; a JAX plan of
another height is not loaded.

The downward (transpose) sweep, ``TilePlan.accumulate_down``, is the sum
of the data over each cell's downstream path, as the JAX package's::

    z, pk = tile_down_a(x)               # T3: path sums to the local roots
    A     = coarse.accumulate_down(pk)   # path sums below each local root
    out   = tile_down_fin(x, z, A)       # T4: z + A[tree], raster order

(T3 alone, in its routed mode, on a graph without entry cells). Its indices
are built at first use (``_ensure_down``): the per-tile (interval end, slot)
order ``es`` and the run boundaries ``g_last``/``g_prev`` from the native
down phase, ``n_tree``, ``ent_slot`` and ``tree_of``; the coarse level's
down indices likewise (``build_down``), for kernels H1 and H0. Every sum has
a fixed order, so a result is the same from run to run in every dtype.

Integer data accumulates in int32, or int64 where ``|max| * n >= 2^31``;
float data in float64. The result comes back in the data's dtype.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import kernels, runtime
from .._backend import resolve_device
from .plan import DfsPlan, accumulate_planned, build_plan
from .router import _chain_np

__all__ = ["TilePlan", "build_tile_plan"]

_S = 128
# below this many coarse slots plain gathers solve the coarse level
_COARSE_ROUTER_MIN = 200_000
# up to this many padded coarse slots the single-chunk router does
_COARSE_SMALL_MAX = 1_870_000

_LATER = "queued for a later slice of the PyTorch port"


def _r128(x):
    return max(((int(x) + 127) // 128) * 128, 128)


def _near_end(near_sel, idx_near, sel_next):
    """Interval end of each near slot (last axis), -1 elsewhere: lane
    ``idx_near`` of the slot's row, or of the next row where ``sel_next``
    (past the last row the JAX package reads 0, so -1 there too)."""
    n = near_sel.shape[-1]
    slot = np.arange(n, dtype=np.int64)
    end = (slot // _S + sel_next.astype(np.int64)) * _S + idx_near.astype(np.int64)
    return np.where((near_sel != 0) & (end < n), end, -1).astype(np.int32)


def _far_end_router(sig_exp, sig_far, far_sel, b):
    """Router far mode: far slot s reads the distinct end routed to the first
    slot of its b-block, ``sig_exp[(sig_far[s] // b) * b]`` (per tile)."""
    blk = (sig_far.astype(np.int64) // b) * b
    fe = np.take_along_axis(sig_exp, blk, axis=1)
    return np.where(far_sel != 0, fe, -1).astype(np.int32)


def _far_end_packed(sig_exp, sig_far, far_sel, rlo, rhi, bhi, bidx):
    """Packed far mode: far slot s reads packed entry q = sig_far[s]; row
    q // 128 of the packed array takes row rlo (or rhi where bhi) of the
    distinct ends and lane bidx of it (per tile). Slots past the packed rows
    read 0."""
    NT = sig_exp.shape[0]
    F = bhi.shape[1] * _S
    if F == 0:
        return np.full(sig_exp.shape, -1, np.int32)
    q = sig_far.astype(np.int64)
    ok = (far_sel != 0) & (q < F)
    qc = np.minimum(q, F - 1)
    r = qc // _S
    row = np.where(
        np.take_along_axis(bhi.reshape(NT, F), qc, axis=1) != 0,
        np.take_along_axis(rhi.astype(np.int64), r, axis=1),
        np.take_along_axis(rlo.astype(np.int64), r, axis=1),
    )
    src = row * _S + np.take_along_axis(bidx.reshape(NT, F).astype(np.int64), qc, axis=1)
    fe = np.take_along_axis(sig_exp, src, axis=1)
    return np.where(ok, fe, -1).astype(np.int32)


def _coarse_far_replay(k_far, d_far, dst_far, sig_exp, sig_far):
    """Replay the JAX coarse level's far values (``_CoarseRouterSmall``
    ``_far_values``): ``sig_exp`` routes the distinct interval ends, a
    row-pair lane gather copies each to its duplicates, ``sig_far`` delivers
    them. Far nodes ``k_far`` span ``d_far`` slots and write output slots
    ``dst_far``; returns (those slots, sorted; the end each reads)."""
    e_far = k_far + d_far
    order = np.lexsort((k_far, e_far))
    uniq_e, inv = np.unique(e_far[order], return_inverse=True)
    F = k_far.size
    d_rows = -(-uniq_e.size // _S)
    f_rows = -(-F // _S)
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


def _stacked_chain(tabs, p, NT):
    """Replay the JAX package's per-tile 5-stage chain of router family
    ``p`` (``ops/tile_plan.py`` ``_local_chain``; one 128-row group, so no
    group stage) on ``arange``: the (NT, T) source index of each destination
    slot."""
    S = _S

    def ta(a, idx):
        return np.take_along_axis(a, np.asarray(idx, np.int64), axis=-1)

    v = np.broadcast_to(np.arange(S * S, dtype=np.int64), (NT, S * S)).reshape(NT, S, S)
    v = ta(v, tabs[f"{p}_i1"]).transpose(0, 2, 1)
    v = ta(v, tabs[f"{p}_is1"])
    v = ta(v, tabs[f"{p}_is2"]).transpose(0, 2, 1)
    v = ta(v, tabs[f"{p}_i3"])
    return v.reshape(NT, S * S).astype(np.int32)


def _compose_down(es, dea, deb, de_sel, de_b0, re_sel, n_tree, ent_slot):
    """The downward sweep's per-tile indices from the sort phase's outputs
    (``runtime.tile_down_phase``, or a JAX plan's chains replayed): the
    padded boundary bijections ``dea``/``deb`` with their masks become
    ``g_last``/``g_prev`` (-1 where masked); ``re_sel`` (root ends) becomes
    ``tree_of``, the number of root ends before each tree slot."""
    de_sel = de_sel != 0
    NT, T = es.shape
    n_tree = np.asarray(n_tree, np.int32)
    re = (re_sel != 0).astype(np.int32)
    tree_of = np.cumsum(re, axis=1, dtype=np.int32) - re
    on = np.arange(T, dtype=np.int32)[None, :] < n_tree[:, None]
    return {
        "es": np.ascontiguousarray(es, np.int32),
        "g_last": np.where(de_sel, dea, -1).astype(np.int32),
        "g_prev": np.where(de_sel & (de_b0 == 0), deb, -1).astype(np.int32),
        "n_tree": n_tree,
        "ent_slot": np.ascontiguousarray(ent_slot, np.int32),
        "tree_of": np.where(on, tree_of, -1).astype(np.int32),
    }


def _coarse_down_arrays(dfs, meta, n_exit_flat):
    """The JAX plan's static coarse-downward arrays (its ``_down["cd"]``):
    ``pre``, ``pos``, ``ends_pre`` of the coarse DFS plan, ``e2n`` (root
    node of each exit slot, -1 where none) and ``wmap`` (``out_slot``)."""
    pre = dfs.preorder_np
    k = pre.size
    e2n = np.full(n_exit_flat, -1, dtype=np.int32)
    e2n[meta["in_slot"][: meta["m"]]] = np.arange(meta["m"], dtype=np.int32)
    return {
        "pre": pre.astype(np.int32),
        "pos": dfs.pos_np.astype(np.int32),
        "ends_pre": (np.arange(k, dtype=np.int64) + dfs.size_np[pre] - 1).astype(np.int32),
        "e2n": e2n,
        "wmap": np.asarray(meta["out_slot"]).astype(np.int32),
    }


# ---------------------------------------------------------------------------
# coarse level, downward: shared by both backends
# ---------------------------------------------------------------------------
class _CoarseDown:
    """The coarse forest's inclusive downstream-path sum, from the packed
    entry (``out_slot``) layout to the exit (``in_slot``) layout, zero at
    slots without a root: the transpose of the backend's ``accumulate``.

    The JAX package's ``_CoarseRouterSmall.accumulate_down`` routes through
    ``r_win``, ``r_es``, ``r_dea``, ``r_deb`` and ``r_aout`` with mask selects
    between flat prefix, shift and suffix sums (its ``_CoarseGather`` level
    scatter-adds instead). The port keeps what those compose to over
    ``n_c`` slots (``_n_down``), as indices of kernels H1 and H0:

    * ``es_in`` (H1): the packed entry read at each position of the
      (interval end, slot) order; nodes without an entry read past the input;
    * ``g_last``, ``g_prev`` (H0): per end slot, the sorted position of its
      run's last node and of the node before its run, else -1 (reads 0);
    * ``win_next`` (H0): the packed entry of the next preorder slot, else -1;
    * ``rev`` (H1): the reversal, so the suffix sum is a prefix sum;
    * ``fin`` (H0): per exit slot, its root's position in the reversed sums.

    One form for both backends: each sum has a fixed order (no atomics)."""

    def build_down(self, cd, routers=None):
        """Build the down indices from the coarse-downward arrays ``cd``
        (:func:`_coarse_down_arrays`, or a JAX plan's) and, for a router
        coarse level loaded from a JAX plan, its ``down_router_tables()``,
        whose chains are replayed instead of sorting here."""
        if getattr(self, "down", None) is not None:
            return
        pre = np.asarray(cd["pre"], np.int64)
        pos = np.asarray(cd["pos"], np.int64)
        ends = np.asarray(cd["ends_pre"], np.int64)
        e2n = np.asarray(cd["e2n"], np.int64)
        k = pre.size
        n_c = self._n_down(k)
        win = np.asarray(cd["wmap"], np.int64)[pre]  # packed entry of each slot
        de_sel = np.zeros(n_c, dtype=bool)
        de_b0 = np.zeros(n_c, dtype=bool)
        if k:
            de_sel[np.unique(ends)] = True
            de_b0[ends.min()] = True  # the first sorted run
        if routers is None:
            order = np.argsort(ends, kind="stable")  # (end, slot) order
            e_sorted = ends[order]
            gstart = np.flatnonzero(np.r_[True, e_sorted[1:] != e_sorted[:-1]][:k])
            glast = np.append(gstart[1:] - 1, k - 1) if k else gstart
            gend = e_sorted[gstart]
            g_last = np.full(n_c, -1, dtype=np.int64)
            g_prev = np.full(n_c, -1, dtype=np.int64)
            g_last[gend] = glast
            g_prev[gend[1:]] = gstart[1:] - 1
        else:
            G = int(routers["G"])
            if G * _S * _S != n_c:
                raise ValueError("down router tables do not fit the coarse plan")
            ar = np.arange(n_c, dtype=np.int64).reshape(G * _S, _S)
            order = _chain_np(ar, G, *routers["r_es"]).ravel()[:k]
            g_last = np.where(de_sel, _chain_np(ar, G, *routers["r_dea"]).ravel(), -1)
            g_prev = np.where(de_sel & ~de_b0, _chain_np(ar, G, *routers["r_deb"]).ravel(), -1)
        es_in = np.full(n_c, n_c, dtype=np.int64)
        es_in[:k] = np.where(win[order] >= 0, win[order], n_c)
        win_next = np.full(n_c, -1, dtype=np.int64)
        win_next[: max(k - 1, 0)] = win[1:]
        root_pos = np.where(e2n >= 0, pos[np.maximum(e2n, 0)], -1)
        fin = np.where(root_pos >= 0, n_c - 1 - root_pos, -1)
        down = {"es_in": es_in, "g_last": g_last, "g_prev": g_prev, "win_next": win_next,
                "rev": np.arange(n_c - 1, -1, -1, dtype=np.int64), "fin": fin}
        self.down = {name: v.astype(np.int32) for name, v in down.items()}
        self._down_t = {name: torch.as_tensor(v, device=self.dfs.device)
                        for name, v in self.down.items()}

    def accumulate_down(self, pkf):
        """``pkf`` ((n_out,) at ``out_slot`` layout; int32, int64 or float64)
        to the path sums at ``in_slot`` layout, (n_in,)."""
        t = self._down_t
        pkf = pkf[: t["es_in"].numel()]  # padded entries past the last real one
        cs = kernels.accel_in_scan(pkf, t["es_in"])
        ge = kernels.permute_gather(cs, t["g_last"]) - kernels.permute_gather(cs, t["g_prev"])
        inner = ge - kernels.permute_gather(pkf, t["win_next"])
        return kernels.permute_gather(kernels.accel_in_scan(inner, t["rev"]), t["fin"])


# ---------------------------------------------------------------------------
# coarse level: plain gathers through the DFS plan (small grids)
# ---------------------------------------------------------------------------
class _CoarseGather(_CoarseDown):
    """Coarse accumulation via the DFS plan and plain gathers (few slots)."""

    def __init__(self, dfs: DfsPlan, in_slot, out_slot, n_in, n_out):
        self.dfs = dfs
        self.n_in = int(n_in)
        self.n_out = int(n_out)
        in_slot = np.asarray(in_slot, np.int64)
        # zero padding for slots past the real input (entry nodes)
        self._in_pad = max(0, int(in_slot.max(initial=-1)) + 1 - self.n_in)
        osel = np.asarray(out_slot, np.int64) >= 0
        dev = dfs.device
        self.in_slot = torch.as_tensor(in_slot, device=dev)
        self.src = torch.as_tensor(np.nonzero(osel)[0], device=dev)
        self.dst = torch.as_tensor(np.asarray(out_slot, np.int64)[osel], device=dev)

    def _n_down(self, k):
        return max(k, self.n_out, 1)

    def accumulate(self, x):
        """Slot-mode accumulation: ``x`` at ``in_slot`` layout, the result at
        ``out_slot`` layout (slots without a value give 0)."""
        if self._in_pad:  # guaranteed-zero slots for no-input entry nodes
            x = torch.cat([x, torch.zeros(self._in_pad, dtype=x.dtype, device=x.device)])
        acc = accumulate_planned(self.dfs, x[self.in_slot])
        out = torch.zeros(self.n_out, dtype=acc.dtype, device=acc.device)
        out[self.dst] = acc[self.src]
        return out


# ---------------------------------------------------------------------------
# coarse level: single-chunk router (kernels H0-H3)
# ---------------------------------------------------------------------------
class _CoarseRouterSmall(_CoarseDown):
    """Slot-mode coarse accumulation on the single-chunk router plan.

    The JAX package's ``_CoarseRouterSmall`` routes and lane-gathers on the
    TPU; the port keeps what those compose to, the four kernels' indices:
    ``src_in`` (H1; entry nodes and padding read past the input, so 0),
    ``near_end`` (H2), ``src_out`` (H0) and ``far_end`` (H3, off-tree slots
    give 0). ``routers`` takes a JAX plan's ``router_tables()``, whose chains
    (and the packed far-group expansion they index) are replayed instead."""

    def __init__(self, dfs: DfsPlan, in_slot, out_slot, n_in=None, routers=None):
        self.dfs = dfs
        pre = dfs.preorder_np
        pos = dfs.pos_np
        size = dfs.size_np
        n_cells = pos.size
        n_tree = pre.size
        in_slot = np.asarray(in_slot, dtype=np.int64)
        out_slot = np.asarray(out_slot, dtype=np.int64)
        self.n_in = (
            int(n_in) if n_in is not None
            else (int(in_slot.max() + 1) if in_slot.size else 1)
        )
        self.n_out = int(out_slot.max() + 1) if out_slot.size else 1
        n_pad = max(n_cells, n_tree, self.n_in, self.n_out, 1)
        n_pad = -(-n_pad // (_S * _S)) * (_S * _S)
        self.ok = n_pad <= _S * _S * _S
        if not self.ok:
            return
        self.n_pad = n_pad

        k = np.arange(n_tree, dtype=np.int64)
        d = size[pre] - 1  # interval k .. k + d
        near = d < _S
        near_end = np.full(n_pad, -1, dtype=np.int64)
        near_end[k[near]] = k[near] + d[near]
        # entry nodes read guaranteed-zero slots past n_in; so do padding
        # slots (H1 reads 0 at source n_pad)
        has_in = in_slot[pre] < self.n_in
        src_in = np.full(n_pad, n_pad, dtype=np.int64)
        cells_o = np.nonzero((pos >= 0) & (out_slot >= 0))[0]
        n_out = self.n_out
        # off-tree output slots give 0 (far_end -2), whatever src_out holds
        far_end = np.full(n_out, -2, dtype=np.int64)
        far_end[out_slot[cells_o]] = -1
        far = ~near & (out_slot[pre] >= 0)
        self.has_far = bool(far.any())
        if routers is None:
            src_in[k[has_in]] = in_slot[pre[has_in]]
            src_out = np.zeros(n_out, dtype=np.int64)
            src_out[out_slot[cells_o]] = pos[cells_o]
            far_end[out_slot[pre[far]]] = k[far] + d[far]
        else:
            G = int(routers["G"])
            ar = np.arange(G * _S * _S, dtype=np.int64).reshape(G * _S, _S)
            src_in[k[has_in]] = _chain_np(ar, G, *routers["r_in"]).ravel()[k[has_in]]
            src_out = _chain_np(ar, G, *routers["r_out"]).ravel()[:n_out]
            if self.has_far:
                sig_exp = _chain_np(ar, G, *routers["r_exp"]).ravel()
                sig_far = _chain_np(ar, G, *routers["r_far"]).ravel()
                cells, fe = _coarse_far_replay(k[far], d[far], out_slot[pre[far]],
                                               sig_exp, sig_far)
                far_end[cells] = fe

        self.src_in = src_in.astype(np.int32)
        self.near_end = near_end.astype(np.int32)
        self.src_out = src_out.astype(np.int32)
        self.far_end = far_end.astype(np.int32)
        dev = dfs.device
        self._t = {name: torch.as_tensor(getattr(self, name), device=dev)
                   for name in ("src_in", "near_end", "src_out", "far_end")}

    def _n_down(self, k):
        return self.n_pad

    def accumulate(self, x):
        """Slot-mode accumulation: ``x`` ((n_in,) at ``in_slot`` layout,
        int32, int64 or float64) to ``out_slot`` layout, (n_out,); slots
        without a value give 0."""
        t = self._t
        c = kernels.accel_in_scan(x, t["src_in"])
        outp = kernels.accel_near_out(c, t["near_end"])
        out = kernels.permute_gather(outp, t["src_out"])
        return kernels.accel_far_merge(out, None, c, t["far_end"])


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
class TilePlan:
    """Per-graph hierarchical accumulation plan over raster tiles.

    Attributes (the JAX plan's decisions): ``shape``, ``pshape`` (padded),
    ``Y`` (tile rows, 128), ``grid``, ``NT``, ``far_mode`` (None, "router" or
    "packed"), ``b``, ``R_pad``, ``E_pad``, ``F_rows``, ``has_far``,
    ``has_entries``, ``coarse``; ``idx``, the composed per-tile indices
    (numpy int32); ``build_seconds``, the host build's steps; after the
    first downward call ``down_idx`` and ``down_build_seconds`` likewise.
    """

    Y = _S

    def __init__(self, idxs_ds_np, shape, device=None):
        secs = {}
        t0 = time.perf_counter()
        self._geometry(shape, device)
        H, W = self.shape
        Hp, Wp = self.pshape
        T, NT = _S * _S, self.NT

        ids0 = np.asarray(idxs_ds_np, dtype=np.int64).ravel()
        n0 = ids0.size
        if n0 != H * W:
            raise ValueError("idxs_ds size does not match shape")
        if (Hp, Wp) != (H, W):
            v0 = ids0 >= 0
            src = np.arange(n0, dtype=np.int64)
            new_of = (src // W) * Wp + src % W
            ids_p = np.full(Hp * Wp, -1, dtype=np.int64)
            tgt = np.full(n0, -1, dtype=np.int64)
            tgt[v0] = (ids0[v0] // W) * Wp + ids0[v0] % W
            ids_p[new_of] = tgt
        else:
            ids_p = ids0

        # ---- phase 1: per-tile forest DFS + local tables (native) -------
        ph = runtime.tile_plan_phase1(ids_p, Hp, Wp, _S)
        slot = ph["slot"]
        root_node = ph["root_node"]
        cnt_r, cnt_far = ph["cnt_r"], ph["cnt_far"]
        root_cell, root_end = ph["root_cell"], ph["root_end"]
        far_slot, far_end = ph["far_slot"], ph["far_end"]
        sig = ph["sig"]
        idx = {"rin": sig}
        rout = np.empty((NT, T), np.int32)
        np.put_along_axis(rout, sig.astype(np.int64),
                          np.broadcast_to(np.arange(T, dtype=np.int32), (NT, T)), 1)
        idx["rout"] = np.where(ph["tree_mask"].reshape(NT, T) != 0, rout, -1)
        del rout
        idx["near_end"] = _near_end(ph["near_sel"].reshape(NT, T),
                                    ph["idx_near"].reshape(NT, T),
                                    ph["sel_next"].reshape(NT, T))
        secs["phase 1"] = time.perf_counter() - t0

        # ---- far cells (interval end >= 128 slots ahead) ----------------
        # each far slot reads its interval end from phase 1. The JAX plan
        # delivers the ends through routers ("router": distinct ends at
        # slots b*j, broadcast within b-blocks) or, past that, a packed
        # group expansion ("packed"): kept as its decisions, not replayed
        t0 = time.perf_counter()
        self.has_far = far_slot.size > 0
        self.far_mode = None
        self.b = 1
        self.F_rows = _r128(cnt_far.max()) // _S if self.has_far else 0
        idx["far_end"] = np.full((NT, T), -1, np.int32)
        if self.has_far:
            ft = np.repeat(np.arange(NT, dtype=np.int64), cnt_far)
            idx["far_end"][ft, far_slot] = far_end
            # nested intervals share ends: b holds the most far cells of one
            uq, dup = np.unique(ft * T + far_end, return_counts=True)
            b = 1 << int(int(dup.max() - 1).bit_length())
            if int(np.bincount(uq // T, minlength=NT).max()) * b <= T and b <= _S:
                self.far_mode, self.b = "router", b
            else:
                self.far_mode = "packed"
        secs["far tables"] = time.perf_counter() - t0

        # ---- exits: local roots in (tile, slot) order --------------------
        t0 = time.perf_counter()
        m = root_cell.size
        rt = np.repeat(np.arange(NT, dtype=np.int64), cnt_r)
        self.R_pad = R_pad = _r128(cnt_r.max() if m else 0)
        roff = np.concatenate([[0], np.cumsum(cnt_r)])
        j = np.arange(m) - np.repeat(roff[:-1], cnt_r)
        # exit slot j <- preorder end of root j (distinct ends: a bijection)
        idx["ex_end"] = np.ascontiguousarray(
            runtime.tile_pad_bijection(rt, j, root_end.astype(np.int64), NT, T)[:, :R_pad])
        secs["exit tables"] = time.perf_counter() - t0

        # ---- coarse graph over roots + entry nodes -----------------------
        # one extra coarse node per distinct entry cell: live roots drain
        # into their cell's entry node, whose subtree sum is the total flow
        # entering that cell; entry nodes read distinct zero slots past the
        # exits
        t0 = time.perf_counter()
        self.n_exit_flat = NT * R_pad
        is_pit = ids_p[root_cell] == root_cell
        ecell = np.where(is_pit, root_cell, ids_p[root_cell])
        e_on = slot[ecell] >= 0
        live = (~is_pit) & e_on
        uq_cell = np.unique(ecell[live])
        D = uq_cell.size
        einv = np.searchsorted(uq_cell, ecell[live])
        coarse_ds = np.full(m + D, -1, dtype=np.int64)
        coarse_ds[np.nonzero(is_pit)[0]] = np.nonzero(is_pit)[0]
        coarse_ds[np.nonzero(live)[0]] = m + einv
        coarse_ds[m:] = root_node[uq_cell]
        in_slot = np.concatenate(
            [rt * R_pad + j, self.n_exit_flat + np.arange(D, dtype=np.int64)]
        )

        # entry nodes grouped by destination tile, ordered by entry slot
        t2 = self._tile_of(uq_cell)
        es = slot[uq_cell].astype(np.int64)
        od = np.lexsort((es, t2))
        t2o, eso = t2[od], es[od]
        cnt_e = np.bincount(t2o, minlength=NT).astype(np.int64)
        self.has_entries = D > 0
        self.E_pad = _r128(cnt_e.max()) if self.has_entries else 0
        out_slot = np.full(m + D, -1, dtype=np.int64)
        idx["ent_idx"] = np.full((NT, T), -1, np.int32)
        if self.has_entries:
            eoff = np.concatenate([[0], np.cumsum(cnt_e)])
            j2 = np.arange(D) - np.repeat(eoff[:-1], cnt_e)
            out_slot[m + od] = t2o * self.E_pad + j2
            if self.E_pad // _S > 127:
                raise ValueError("entry rows exceed the int8 row table")
            # for each preorder slot, the packed rank of the last entry at a
            # slot <= s (entries are packed in slot order)
            ind = np.zeros((NT, T), dtype=np.int32)
            ind[t2o, eso] = 1
            cnt_le = np.cumsum(ind, axis=1, dtype=np.int32)
            idx["ent_idx"] = np.where(cnt_le > 0, cnt_le - 1, -1).astype(np.int32)
        self._coarse_meta = {"in_slot": in_slot, "out_slot": out_slot,
                             "m": int(m), "D": int(D)}
        secs["coarse graph"] = time.perf_counter() - t0

        # what the lazy downward build needs of phase 1 (_ensure_down)
        ent_slot = np.full((NT, self.E_pad), -1, np.int32)
        if self.has_entries:
            ent_slot[t2o, j2] = eso
        re_sel = np.zeros((NT, T), np.int8)
        re_sel[rt, root_end] = 1
        self._down_src = {
            "phase": (ph["near_sel"], ph["idx_near"], ph["sel_next"], sig, cnt_far,
                      far_slot, far_end),
            "re_sel": re_sel, "n_tree": ph["cnt_on"], "ent_slot": ent_slot,
        }

        t0 = time.perf_counter()
        self.coarse = self._coarse_level(build_plan(coarse_ds, device=self.device))
        secs["coarse plan"] = time.perf_counter() - t0
        self._finish(idx, secs)

    # -- shared by both constructors -------------------------------------
    def _geometry(self, shape, device):
        H, W = map(int, shape)
        self.device = resolve_device(device)
        self.shape = (H, W)
        self.grid = (-(-H // _S), -(-W // _S))
        self.pshape = (self.grid[0] * _S, self.grid[1] * _S)
        self.NT = self.grid[0] * self.grid[1]

    def _coarse_level(self, dfs_c):
        """The JAX package's coarse backend choice; raises where it would
        take BigAccelPlan."""
        meta = self._coarse_meta
        n_out = self.NT * max(self.E_pad, 1)
        if max(self.n_exit_flat, n_out) < _COARSE_ROUTER_MIN:
            return _CoarseGather(dfs_c, meta["in_slot"], meta["out_slot"],
                                 self.n_exit_flat, n_out)
        if max(self.n_exit_flat, n_out, meta["m"] + meta["D"]) <= _COARSE_SMALL_MAX:
            small = _CoarseRouterSmall(dfs_c, meta["in_slot"], meta["out_slot"],
                                       n_in=self.n_exit_flat)
            if small.ok:
                return small
        raise NotImplementedError(
            "the tile plan's coarse level needs BigAccelPlan (ops/accel_big.py) "
            f"at this size, {_LATER}"
        )

    def _finish(self, idx, secs):
        t0 = time.perf_counter()
        self.idx = idx
        self.idx_t = {k: torch.as_tensor(v, device=self.device) for k, v in idx.items()}
        secs["upload"] = time.perf_counter() - t0
        self.build_seconds = secs
        self.down_idx = None

    def _ensure_down(self):
        """Build, once, the downward sweep's indices (``down_idx``, uploaded
        as ``down_idx_t``) and the coarse level's (``coarse.build_down``)."""
        if self.down_idx is not None:
            return
        secs = {}
        src = self._down_src
        NT, T = self.NT, _S * _S
        t0 = time.perf_counter()
        if "phase" in src:  # native build: sort each tile's slots by end
            es, dea, deb, de_sel, de_b0 = runtime.tile_down_phase(*src["phase"], NT, T)
            cd, routers = _coarse_down_arrays(self.coarse.dfs, self._coarse_meta,
                                              self.n_exit_flat), None
            n_tree, ent_slot, re_sel = src["n_tree"], src["ent_slot"], src["re_sel"]
        else:  # a JAX plan's down tables: replay its chains
            tabs = src["tabs"]

            def flat(name):
                return np.asarray(tabs[name]).reshape(NT, T)

            es, dea, deb = (_stacked_chain(tabs, p, NT) for p in ("es", "dea", "deb"))
            de_sel, de_b0, re_sel = flat("de_sel"), flat("de_b0"), flat("re_sel")
            cd, routers = src["cd"], src["routers"]
            n_tree = src["n_tree"]
            ent_slot = np.full((NT, self.E_pad), -1, np.int32)
            if self.has_entries:
                # the entry router is padded to a bijection: only the real
                # entries (those with a coarse node) carry a slot
                real = np.zeros(NT * self.E_pad, dtype=bool)
                osl = np.asarray(self._coarse_meta["out_slot"])
                real[osl[osl >= 0]] = True
                enti = _stacked_chain(tabs, "enti", NT)[:, : self.E_pad]
                ent_slot = np.where(real.reshape(NT, self.E_pad), enti, -1)
        secs["sort phase"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        down_idx = _compose_down(es, dea, deb, de_sel, de_b0, re_sel, n_tree, ent_slot)
        secs["compose"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.coarse.build_down(cd, routers=routers)
        secs["coarse down"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.down_idx_t = {k: torch.as_tensor(v, device=self.device)
                           for k, v in down_idx.items()}
        secs["upload"] = time.perf_counter() - t0
        self.down_idx = down_idx
        self.down_build_seconds = secs
        self._down_src = None

    def _tile_of(self, cells):
        """Tile index of padded-grid cell ids."""
        Wp = self.pshape[1]
        ntx = self.grid[1]
        cells = np.asarray(cells, dtype=np.int64)
        return (cells // Wp // _S) * ntx + (cells % Wp) // _S

    # -- a JAX plan's tables ----------------------------------------------
    @classmethod
    def from_stage_tables(cls, tabs, cfg, coarse_meta, coarse_dfs, routers=None,
                          down=None, device=None) -> "TilePlan":
        """Build the plan from a JAX ``TilePlan``'s host arrays: ``tabs``
        (its ``_tabs_np``), ``cfg`` (``shape``, ``tile_rows``, ``far_mode``,
        ``b``, ``R_pad``, ``E_pad``, ``has_far``, ``has_entries``),
        ``coarse_meta`` (its ``_coarse_meta``), ``coarse_dfs`` (the coarse
        DFS plan's ``(preorder, pos, size)``) and, for a ``_CoarseRouterSmall``
        coarse level, ``routers`` (its ``router_tables()``). Each per-tile
        chain is replayed on ``arange`` into the port's composed index.
        ``down`` carries the JAX plan's downward tables for
        :meth:`accumulate_down`: ``tabs`` (its ``_down["tabs"]``), ``cd`` (its
        ``_down["cd"]``) and, for a router coarse level, ``routers`` (its
        ``coarse.down_router_tables()``); without it ``accumulate_down``
        raises. Plans of tiles other than 128 rows high raise
        NotImplementedError."""
        if int(cfg["tile_rows"]) != _S:
            raise NotImplementedError(
                f"tile plans of {cfg['tile_rows']} rows: the port's tiles are 128 rows "
                f"high; loading other heights is {_LATER}"
            )
        self = cls.__new__(cls)
        secs = {}
        t0 = time.perf_counter()
        self._geometry(cfg["shape"], device)
        NT, T = self.NT, _S * _S
        self.far_mode = cfg["far_mode"]
        self.b = int(cfg["b"])
        self.R_pad = int(cfg["R_pad"])
        self.E_pad = int(cfg["E_pad"])
        self.F_rows = int(cfg["F_rows"])
        self.has_far = bool(cfg["has_far"])
        self.has_entries = bool(cfg["has_entries"])
        self.n_exit_flat = NT * self.R_pad

        def flat(name):
            return np.asarray(tabs[name]).reshape(NT, T)

        idx = {"rin": _stacked_chain(tabs, "rin", NT)}
        idx["rout"] = np.where(flat("tree_mask") != 0,
                               _stacked_chain(tabs, "rout", NT), -1).astype(np.int32)
        idx["near_end"] = _near_end(flat("near_sel"), flat("idx_near"), flat("sel_next"))
        idx["far_end"] = np.full((NT, T), -1, np.int32)
        if self.far_mode is not None:
            sig_exp = _stacked_chain(tabs, "fexp", NT)
            sig_far = _stacked_chain(tabs, "ffar", NT)
            if self.far_mode == "router":
                idx["far_end"] = _far_end_router(sig_exp, sig_far, flat("far_sel"), self.b)
            else:
                idx["far_end"] = _far_end_packed(
                    sig_exp, sig_far, flat("far_sel"),
                    np.asarray(tabs["far_rlo"])[:, :, 0], np.asarray(tabs["far_rhi"])[:, :, 0],
                    tabs["far_bhi"], tabs["far_bidx"],
                )
        idx["ex_end"] = np.ascontiguousarray(_stacked_chain(tabs, "ex", NT)[:, : self.R_pad])
        idx["ent_idx"] = np.full((NT, T), -1, np.int32)
        if self.has_entries:
            ent = flat("ent_row").astype(np.int32) * _S + flat("ent_lane").astype(np.int32)
            idx["ent_idx"] = np.where(flat("ent_sel") != 0, ent, -1).astype(np.int32)
        secs["replay"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self._coarse_meta = coarse_meta
        dfs_c = DfsPlan(*coarse_dfs, device=self.device)
        if routers is None:
            self.coarse = _CoarseGather(dfs_c, coarse_meta["in_slot"], coarse_meta["out_slot"],
                                        self.n_exit_flat, NT * max(self.E_pad, 1))
        elif "G" in routers:
            self.coarse = _CoarseRouterSmall(dfs_c, coarse_meta["in_slot"],
                                             coarse_meta["out_slot"],
                                             n_in=self.n_exit_flat, routers=routers)
        else:
            raise NotImplementedError(f"a BigAccelPlan coarse level is {_LATER}")
        secs["coarse plan"] = time.perf_counter() - t0
        self._down_src = None
        if down is not None:
            self._down_src = {"tabs": down["tabs"], "cd": down["cd"],
                              "routers": down.get("routers"),
                              "n_tree": (flat("tree_mask") != 0).sum(1)}
        self._finish(idx, secs)
        return self

    # -- execution -----------------------------------------------------------
    @staticmethod
    def _acc_dtype(data):
        """float64 for float data; int32 for integer data unless
        ``|max| * n >= 2^31``, then int64."""
        if data.dtype.is_floating_point:
            return torch.float64
        amax = 1
        if data.numel() and data.dtype != torch.bool:
            lo, hi = torch.aminmax(data)  # one read, no int64 copy
            amax = max(-int(lo), int(hi))
        return torch.int64 if amax * data.numel() >= 1 << 31 else torch.int32

    def accumulate(self, data):
        """Flow accumulation of ``data`` ((H*W,) tensor in raster order on
        the plan's device): tree cells get their subtree sum, missing cells
        pass through. Returned in ``data``'s dtype."""
        H, W = self.shape
        if data.numel() != H * W:
            raise ValueError(f"data must hold {H * W} values")
        x = data.reshape(-1).to(self._acc_dtype(data)).contiguous()
        t = self.idx_t
        exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], self.shape)
        entv = self.entry_grid(self.coarse.accumulate(exits.reshape(-1)))
        out = kernels.tile_pass_c(x, c, entv, t["ent_idx"], t["near_end"],
                                  t["far_end"], t["rout"], self.shape)
        return out.to(data.dtype)

    def accumulate_down(self, data):
        """Inclusive downstream-path sum of ``data`` ((H*W,) tensor in raster
        order on the plan's device): ``a[i]`` sums ``data`` over ``i``, its
        downstream cell, ..., its pit; the transpose of :meth:`accumulate`.
        Missing cells pass through. Returned in ``data``'s dtype; integers
        are exact, and every dtype gives the same bits from run to run."""
        H, W = self.shape
        if data.numel() != H * W:
            raise ValueError(f"data must hold {H * W} values")
        if self.down_idx is None and self._down_src is None:
            raise RuntimeError("the plan was loaded without its downward tables")
        self._ensure_down()
        x = data.reshape(-1).to(self._acc_dtype(data)).contiguous()
        t, d = self.idx_t, self.down_idx_t
        d1 = (t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
        if self.has_entries and self.coarse.dfs.n_tree > 0:
            # raw D1: routing and passthrough wait for D2
            z, pk = kernels.tile_down_a(x, *d1, None, self.shape, False)
            A = self.coarse.accumulate_down(pk.reshape(-1))
            out = kernels.tile_down_fin(x, z, A.reshape(self.NT, self.R_pad),
                                        d["tree_of"], t["rout"], self.shape)
        else:
            out, _ = kernels.tile_down_a(x, *d1, t["rout"], self.shape, True)
        return out.to(data.dtype)

    def entry_grid(self, entv):
        """The coarse level's entry values (out_slot layout) as the
        (NT, E_pad) grid pass C reads, zero padded."""
        n = self.NT * self.E_pad
        if entv.numel() < n:
            entv = torch.cat([entv, entv.new_zeros(n - entv.numel())])
        return entv[:n].reshape(self.NT, self.E_pad)


def build_tile_plan(idxs_ds_np, shape, device=None) -> TilePlan:
    """Build a :class:`TilePlan` for a raster graph on ``device``.

    Raises ValueError where the JAX package's build raises (it then falls
    back to host sweeps) and NotImplementedError where it would take
    ``BigAccelPlan`` for the coarse level; neither is ported yet."""
    return TilePlan(idxs_ds_np, shape, device=device)
