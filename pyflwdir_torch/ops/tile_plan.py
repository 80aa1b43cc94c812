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


# ---------------------------------------------------------------------------
# coarse level: plain gathers through the DFS plan (small grids)
# ---------------------------------------------------------------------------
class _CoarseGather:
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
class _CoarseRouterSmall:
    """Slot-mode coarse accumulation on the single-chunk router plan.

    The JAX package's ``_CoarseRouterSmall`` routes and lane-gathers on the
    TPU; the port keeps what those compose to, the four kernels' indices:
    ``src_in`` (H1; entry nodes and padding read past the input, so 0),
    ``near_end`` (H2), ``src_out`` (H0) and ``far_end`` (H3, off-tree slots
    give 0). ``routers`` takes a JAX plan's ``router_tables()``, whose chains
    (and the packed far-group expansion they index) are replayed instead."""

    def __init__(self, dfs: DfsPlan, in_slot, out_slot, n_in=None, routers=None):
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
    (numpy int32); ``build_seconds``, the host build's steps.
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

    def _tile_of(self, cells):
        """Tile index of padded-grid cell ids."""
        Wp = self.pshape[1]
        ntx = self.grid[1]
        cells = np.asarray(cells, dtype=np.int64)
        return (cells // Wp // _S) * ntx + (cells % Wp) // _S

    # -- a JAX plan's tables ----------------------------------------------
    @classmethod
    def from_stage_tables(cls, tabs, cfg, coarse_meta, coarse_dfs, routers=None,
                          device=None) -> "TilePlan":
        """Build the plan from a JAX ``TilePlan``'s host arrays: ``tabs``
        (its ``_tabs_np``), ``cfg`` (``shape``, ``tile_rows``, ``far_mode``,
        ``b``, ``R_pad``, ``E_pad``, ``has_far``, ``has_entries``),
        ``coarse_meta`` (its ``_coarse_meta``), ``coarse_dfs`` (the coarse
        DFS plan's ``(preorder, pos, size)``) and, for a ``_CoarseRouterSmall``
        coarse level, ``routers`` (its ``router_tables()``). Each per-tile
        chain is replayed on ``arange`` into the port's composed index.
        Plans of tiles other than 128 rows high raise NotImplementedError."""
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
