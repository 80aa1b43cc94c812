"""Hierarchical tile plan: flow accumulation of rasters above 2^21 cells.

The raster is cut into tiles of ``Y`` rows by 128 columns, ``Y`` 128
(the default), 256, 384 or 512 as the JAX package takes it (``tile_rows``;
``G = Y / 128``, ``T = 128 Y`` cells a tile). The flow graph inside a
tile is a forest whose roots are pits and tile-exit cells; each tile gets a
DFS preorder of its own, so every local subtree is a preorder interval and
its sum a difference of two prefix sums. One accumulation is three steps,
as in the JAX package's ``TilePlan.accumulate`` (fused A -> C)::

    exits, c = tile_pass_a(x)            # T1: per-tile prefix sums, root sums
    entries  = coarse.accumulate(exits)  # root -> entry graph, ~n/100 nodes
    out      = tile_pass_c(x, c, entries)  # T2: inject inflows, differences

The coarse level is the same slot-mode accumulation as the JAX package's:
plain gathers through the DFS plan below ``_COARSE_ROUTER_MIN`` slots
(``_CoarseGather``), else the single-chunk router (``_CoarseRouterSmall``)
up to ``_COARSE_SMALL_MAX`` slots and ``BigAccelPlan``
(``ops/accel_big.py``) above that, both on kernels H1-H3 upward and H1 and
H0 downward; past the big plan's 2^28 slots the build raises ValueError, as
the JAX build does.

The host build makes the JAX build's decisions (the phase-1 DFS, the far
mode and ``b``, ``R_pad``, ``E_pad``, the coarse graph and its slots, the
coarse backend thresholds), so the two dispatch identically. Where the JAX
plan keeps 5-stage int8 router tables per family, the port keeps one index
per slot (``rin``, ``rout``, ``ex_end``, ``near_end``, ``far_end``,
``ent_idx``, each relative to its tile), what each chain composes to; the
native build takes them from phase 1 directly (the far mode and ``b`` say
only how the TPU routers deliver the far ends). :meth:`TilePlan.from_stage_tables`
builds the same indices from a JAX plan's tables by replaying the chains on
``arange``.

The per-tile indices stay on the host (numpy int32, or memory-mapped where
the plan was loaded from disk, ``ops/plan_io.py``) until the first
monolithic call uploads them (``idx_t``) as the kernels' index type
(:func:`tile_table`): int16 up to 256 rows, where every value lies below
32,768 or is -1, which halves the bytes the kernels read and the plan's
size on the device, int32 above. :meth:`TilePlan.accumulate_banded`
never does: it runs the unfused passes band by band, with only one band's
slices of the indices on the device::

    for each band:  exits[band] = tile_pass_a(x[band], emit_c=False)  # T1, exits only
    entries = coarse.accumulate(exits)
    for each band:  out[band] = tile_pass_c(x[band], c=None, ...)     # T2, full mode

The downward (transpose) sweep, ``TilePlan.accumulate_down``, is the sum
of the data over each cell's downstream path, as the JAX package's::

    z, pk = tile_down_a(x)               # T3: path sums to the local roots
    A     = coarse.accumulate_down(pk)   # path sums below each local root
    out   = tile_down_fin(x, z, A)       # T4: z + A[tree], raster order

(T3 alone, in its routed mode, on a graph without entry cells). Its indices
are built at first use (``_ensure_down``): the per-tile (interval end, slot)
order ``es`` and the run boundaries ``g_last``/``g_prev`` from the native
down phase, ``n_tree``, ``ent_slot`` and ``tree_of`` (on the device of a
plan of taller tiles in raster layout, ``tree_of[rout]``: :func:`tree_table`);
the coarse level's down indices likewise (``build_down``), for kernels H1
and H0. Every sum has a fixed order, so a result is the same from run to
run in every dtype.

Both sweeps also run sharded over the ranks of a
:class:`pyflwdir_torch.parallel.Mesh` (:meth:`TilePlan.accumulate_sharded`,
:meth:`TilePlan.accumulate_down_sharded`), as the JAX package's do under
``shard_map``: each rank takes a contiguous slab of ``NT / size`` tiles,
which may start and end in the middle of a tile row, runs the kernels on it
in their tile-range form, and the ranks meet in one gather between the two
passes and one of the result::

    exits, c = tile_pass_a(x, slab)      # T1 (in chunks, each gathered at once)
    entries  = coarse.accumulate(all_gather(exits))
    out      = tile_pass_c(x, c, entries[slab])  # T2: the slab's tile stack

    abar, pk = tile_down_a(x, slab)      # T3 routed: the slab's tile stack
    A        = coarse.accumulate_down(all_gather(pk))
    out      = tile_down_lite(abar, A[slab])     # T4 lite: abar + A[tree]

Data sums in the dtype of :func:`pyflwdir_torch.kernels.sum_dtype` and comes
back in its own, through ``kernels.cast_in`` and ``kernels.cast_back``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, runtime, trace
from .._backend import resolve_device
from .accel_big import BigAccelPlan, CoarseDown, RouterAccel
from .plan import DfsPlan, accumulate_planned, build_plan

__all__ = ["TilePlan", "build_tile_plan", "tile_table", "tree_table"]

_S = 128
# below this many coarse slots plain gathers solve the coarse level
_COARSE_ROUTER_MIN = 200_000
# up to this many padded coarse slots the single-chunk router does
_COARSE_SMALL_MAX = 1_870_000



def _tile_rows(tile_rows):
    """The tile height, checked as the JAX build checks it."""
    th = int(tile_rows)
    if th <= 0 or th % _S or th > 512:
        raise ValueError("tile_rows must be a multiple of 128, <= 512")
    return th


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


def _stacked_chain(tabs, p, NT, Y):
    """Replay the JAX package's per-tile 5-stage chain of router family
    ``p`` (``ops/tile_plan.py`` ``_local_chain``: the row stage, a transpose
    of each 128-row group, the column stage, the group stage ``{p}_ig``
    across the ``G = Y / 128`` groups where G > 1, the second column stage,
    a transpose back and the last row stage) on ``arange``: the (NT, Y * 128)
    source index of each destination slot."""
    S, G = _S, Y // _S

    def ta(a, idx):
        return np.take_along_axis(a, np.asarray(idx, np.int64).reshape(a.shape), axis=-1)

    def group_t(v):  # (NT, Y, S): transpose each 128 x 128 group
        return v.reshape(NT, G, S, S).transpose(0, 1, 3, 2).reshape(NT, Y, S)

    v = np.broadcast_to(np.arange(Y * S, dtype=np.int64), (NT, Y * S)).reshape(NT, Y, S)
    v = group_t(ta(v, tabs[f"{p}_i1"]))
    v = ta(v, tabs[f"{p}_is1"])
    if G > 1:  # (NT, G, S, S) -> (NT, S * S, G): lane c2 * 128 + c, group g
        v = v.reshape(NT, G, S, S).transpose(0, 3, 2, 1).reshape(NT, S * S, G)
        v = ta(v, tabs[f"{p}_ig"])
        v = v.reshape(NT, S, S, G).transpose(0, 3, 2, 1).reshape(NT, Y, S)
    v = group_t(ta(v, tabs[f"{p}_is2"]))
    v = ta(v, tabs[f"{p}_i3"])
    return v.reshape(NT, Y * S).astype(np.int32)


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


def _upload(a, device):
    """A host array (numpy or a memory map, or a slice of one) as a tensor on
    ``device``."""
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def tile_table(a, rows=_S, device=None):
    """A per-tile index table of a plan of ``rows``-row tiles (host int32,
    numpy or a memory map, or a slice of one) as the tensor the kernels
    T1-T4 read, on ``device``: int16 up to 256 rows, int32 above
    (:func:`pyflwdir_torch.kernels.tile_table_dtype`). Every such table
    holds a tile-local slot, cell, entry rank or tree index below ``128 *
    rows``, or -1; the values are kept as they are. Raises ValueError where a
    value falls outside that dtype. The range check and the cast run on
    ``device``: on the card they cost the host nothing beyond the copy."""
    return _cast_checked(_upload(a, device), kernels.tile_table_dtype(rows), "tile table")


def _cast_checked(t, dtype, what):
    """``t`` cast to ``dtype`` on its device; ValueError where a value
    falls outside that dtype."""
    if t.numel():
        lo, hi = trace.host_ints("cast_checked", *torch.aminmax(t))
        info = torch.iinfo(dtype)
        if lo < info.min or hi > info.max:
            raise ValueError(f"{what} values {lo}..{hi} fall outside "
                             f"{str(dtype).replace('torch.', '')}")
    return t.to(dtype)


def tree_table(tree_of, rout, R, rows=_S, device=None):
    """T4's tree table of a plan of ``rows``-row tiles with ``R`` (``R_pad``)
    local roots a tile, on ``device``, from the host ``tree_of`` (preorder
    layout) and ``rout`` (int32, numpy or memory maps, or slices of them):
    at 128 rows ``tree_of`` itself (:func:`tile_table`); on taller tiles,
    composed on the device into raster layout,
    ``tree_r[t, l] = rout[t, l] >= 0 ? tree_of[t, rout[t, l]] : -1``, so that
    T4 finds a cell's tree without a gather, in
    :func:`pyflwdir_torch.kernels.tile_tree_dtype` (int16 where ``R`` <=
    32,767). Raises ValueError where a value falls outside that dtype."""
    if rows == _S:
        return tile_table(tree_of, rows, device)
    ro = _upload(rout, device).long()
    tr = torch.gather(_upload(tree_of, device), 1, ro.clamp(min=0))
    tr = torch.where(ro >= 0, tr, torch.full((), -1, dtype=tr.dtype, device=tr.device))
    return _cast_checked(tr, kernels.tile_tree_dtype(rows, R), "tree table")


def _upload_table(key, a, rows, device):
    """Table ``key`` of a plan of ``rows``-row tiles on ``device``: the
    kernels' index type (:func:`tile_table`), but ``n_tree`` (one count per
    tile) int32."""
    return _upload(a, device) if key == "n_tree" else tile_table(a, rows, device)


class _BandSink:
    """Takes pass C's band results on the device, in band order, and hands
    each to the host one band late: on CUDA, band b's copy to pinned memory
    runs on a stream of its own while band b + 1's kernels run, and band b
    reaches ``out_cb(b, r0, array)`` (or the assembled result) only after
    band b + 1 is enqueued."""

    def __init__(self, shape, out_cb, device):
        self.shape, self.out_cb = shape, out_cb
        self.full = None
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.pending = None

    def put(self, b, r0, band):
        done = None
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record()
            host = torch.empty(band.shape, dtype=band.dtype, pin_memory=True)
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(ready)
                host.copy_(band, non_blocking=True)
                band.record_stream(self.stream)
                done = torch.cuda.Event()
                done.record(self.stream)
            band = host
        prev, self.pending = self.pending, (b, r0, band, done)
        if prev is not None:
            self._flush(*prev)

    def _flush(self, b, r0, band, done):
        if done is not None:
            done.synchronize()
        a = band.numpy()
        if self.out_cb is not None:
            self.out_cb(b, r0, a)
            return
        if self.full is None:
            self.full = np.empty(self.shape, a.dtype)
        self.full[r0: r0 + a.shape[0]] = a

    def finish(self):
        if self.pending is not None:
            self._flush(*self.pending)
        self.pending = None
        return self.full


def _coarse_down_arrays(dfs, meta, n_exit_flat):
    """The static coarse-downward arrays (as in the JAX plan's
    ``_down["cd"]``): ``pre`` and ``pos`` of the coarse DFS plan, ``e2n``
    (root node of each exit slot, -1 where none) and ``wmap`` (``out_slot``)."""
    e2n = np.full(n_exit_flat, -1, dtype=np.int32)
    e2n[meta["in_slot"][: meta["m"]]] = np.arange(meta["m"], dtype=np.int32)
    return {
        "pre": dfs.preorder_np.astype(np.int32),
        "pos": dfs.pos_np.astype(np.int32),
        "e2n": e2n,
        "wmap": np.asarray(meta["out_slot"]).astype(np.int32),
    }


# ---------------------------------------------------------------------------
# coarse level: plain gathers through the DFS plan (small grids)
# ---------------------------------------------------------------------------
class _CoarseGather(CoarseDown):
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
# coarse level: single-chunk router (kernels H1-H3)
# ---------------------------------------------------------------------------
class _CoarseRouterSmall(RouterAccel):
    """Slot-mode coarse accumulation on the single-chunk router plan: up to
    2^21 slots, padded to 16,384.

    The JAX package's ``_CoarseRouterSmall`` routes and lane-gathers on the
    TPU; the port keeps what those compose to, the four host indices of
    :class:`pyflwdir_torch.ops.accel_big.RouterAccel`: ``src_in`` (H1;
    entry nodes, whose ``in_slot`` lies past ``n_in``, and padding read past
    the input, so 0), ``near_end`` and ``far_end`` (one interval end a slot
    for H2) and ``src_out`` (H3; off-tree slots give 0). ``routers`` takes a
    JAX plan's ``router_tables()`` (keyed ``"G"``), whose chains (and the
    packed far-group expansion they index) are replayed instead."""

    def __init__(self, dfs: DfsPlan, in_slot, out_slot, n_in=None, routers=None):
        if n_in is None:
            n_in = int(np.max(in_slot, initial=0)) + 1
        self._build(dfs, in_slot, out_slot, n_in, _S * _S, _S * _S * _S, routers)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
class TilePlan:
    """Per-graph hierarchical accumulation plan over raster tiles.

    Attributes (the JAX plan's decisions): ``shape``, ``pshape`` (padded),
    ``Y`` (tile rows: 128, 256, 384 or 512), ``G`` (``Y / 128``), ``grid``,
    ``NT``, ``far_mode`` (None, "router" or
    "packed"), ``b``, ``R_pad``, ``E_pad``, ``F_rows``, ``has_far``,
    ``has_entries``, ``coarse``; ``idx``, the composed per-tile indices
    (numpy int32); ``build_seconds``, the host build's steps; after the
    first downward call ``down_idx`` and ``down_build_seconds`` likewise.
    """

    def __init__(self, idxs_ds_np, shape, tile_rows=128, device=None):
        secs = {}
        with trace.timed("plan.phase1") as s:
            self._geometry(shape, device, tile_rows)
            H, W = self.shape
            Hp, Wp = self.pshape
            T, NT = self.Y * _S, self.NT

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

            # ---- phase 1: per-tile forest DFS + local tables (native) ---
            ph = runtime.tile_plan_phase1(ids_p, Hp, Wp, self.Y)
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
        secs["phase 1"] = s.seconds

        # ---- far cells (interval end >= 128 slots ahead) ----------------
        # each far slot reads its interval end from phase 1. The JAX plan
        # delivers the ends through routers ("router": distinct ends at
        # slots b*j, broadcast within b-blocks) or, past that, a packed
        # group expansion ("packed"): kept as its decisions, not replayed
        with trace.timed("plan.far_tables") as s:
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
        secs["far tables"] = s.seconds

        # ---- exits: local roots in (tile, slot) order --------------------
        with trace.timed("plan.exit_tables") as s:
            m = root_cell.size
            rt = np.repeat(np.arange(NT, dtype=np.int64), cnt_r)
            self.R_pad = R_pad = _r128(cnt_r.max() if m else 0)
            roff = np.concatenate([[0], np.cumsum(cnt_r)])
            j = np.arange(m) - np.repeat(roff[:-1], cnt_r)
            # exit slot j <- preorder end of root j (distinct ends: a bijection)
            idx["ex_end"] = np.ascontiguousarray(
                runtime.tile_pad_bijection(rt, j, root_end.astype(np.int64), NT, T)[:, :R_pad])
        secs["exit tables"] = s.seconds

        # ---- coarse graph over roots + entry nodes -----------------------
        # one extra coarse node per distinct entry cell: live roots drain
        # into their cell's entry node, whose subtree sum is the total flow
        # entering that cell; entry nodes read distinct zero slots past the
        # exits
        with trace.timed("plan.coarse_graph") as s:
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
        secs["coarse graph"] = s.seconds

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

        with trace.timed("plan.coarse_plan") as s:
            self.coarse = self._coarse_level(build_plan(coarse_ds, device=self.device))
        secs["coarse plan"] = s.seconds
        self._finish(idx, secs)

    # -- shared by both constructors -------------------------------------
    def _geometry(self, shape, device, tile_rows):
        H, W = map(int, shape)
        self.device = resolve_device(device)
        self.shape = (H, W)
        self.Y = _tile_rows(tile_rows)
        self.G = self.Y // _S
        self.grid = (-(-H // self.Y), -(-W // _S))
        self.pshape = (self.grid[0] * self.Y, self.grid[1] * _S)
        self.NT = self.grid[0] * self.grid[1]

    def _config(self, cfg, device):
        """The geometry (``shape``, ``tile_rows``: a multiple of 128 up to
        512, else ValueError) and the decisions of a saved or a JAX plan's
        ``cfg``, with the plan on ``device``."""
        self._geometry(cfg["shape"], device, cfg["tile_rows"])
        self.far_mode = cfg["far_mode"]
        self.b = int(cfg["b"])
        self.R_pad = int(cfg["R_pad"])
        self.E_pad = int(cfg["E_pad"])
        self.F_rows = int(cfg["F_rows"])
        self.has_far = bool(cfg["has_far"])
        self.has_entries = bool(cfg["has_entries"])
        self.n_exit_flat = self.NT * self.R_pad

    def _coarse_level(self, dfs_c, kind=None):
        """The JAX package's coarse backend choice, or ``kind`` (the class
        name of a saved plan's coarse level)."""
        meta = self._coarse_meta
        n_out = self.NT * max(self.E_pad, 1)
        if kind is None:
            if max(self.n_exit_flat, n_out) < _COARSE_ROUTER_MIN:
                kind = "_CoarseGather"
            elif max(self.n_exit_flat, n_out, meta["m"] + meta["D"]) <= _COARSE_SMALL_MAX:
                kind = "_CoarseRouterSmall"
        if kind == "_CoarseGather":
            return _CoarseGather(dfs_c, meta["in_slot"], meta["out_slot"],
                                 self.n_exit_flat, n_out)
        if kind == "_CoarseRouterSmall":
            small = _CoarseRouterSmall(dfs_c, meta["in_slot"], meta["out_slot"],
                                       n_in=self.n_exit_flat)
            if small.ok:
                return small
        big = BigAccelPlan(dfs_c, None, in_slot=meta["in_slot"], out_slot=meta["out_slot"])
        if not big.ok:
            raise ValueError("coarse graph exceeds router capacity")
        return big

    def _finish(self, idx, secs):
        self.idx = idx
        self._idx_t = None
        self._slabs = {}
        self.upload_seconds = None
        self.build_seconds = secs
        self.down_idx = None
        self._down_idx_t = None

    @property
    def idx_t(self):
        """The per-tile indices on the plan's device, in the kernels' index
        type (:func:`tile_table`), uploaded at the first call that needs
        them all (``upload_seconds``)."""
        if self._idx_t is None:
            with trace.timed("plan.upload") as s:
                self._idx_t = {k: _upload_table(k, v, self.Y, self.device)
                               for k, v in self.idx.items()}
            self.upload_seconds = s.seconds
        return self._idx_t

    @property
    def down_idx_t(self):
        """The downward sweep's indices on the plan's device, typed as
        :attr:`idx_t` but ``n_tree`` (int32), after :meth:`_ensure_down`."""
        if self._down_idx_t is None:
            with trace.span("plan.down.upload"):
                self._down_idx_t = {k: self._upload_down(k) for k in self.down_idx}
        return self._down_idx_t

    def _upload_down(self, key, rows=slice(None)):
        """Rows ``rows`` of down table ``key`` on the plan's device;
        ``tree_of`` as T4 reads it (:func:`tree_table`: raster layout on a
        tall plan)."""
        a = self.down_idx[key][rows]
        if key == "tree_of":
            return tree_table(a, self.idx["rout"][rows], self.R_pad, self.Y, self.device)
        return _upload_table(key, a, self.Y, self.device)

    def _ensure_down(self):
        """Build, once, the downward sweep's indices (``down_idx``, uploaded
        at first use as ``down_idx_t``) and the coarse level's
        (``coarse.build_down``)."""
        if self.down_idx is not None:
            return
        if self._down_src is None:
            raise RuntimeError("the plan was loaded without its downward tables")
        secs = {}
        src = self._down_src
        NT, T = self.NT, self.Y * _S
        with trace.timed("plan.down.sort") as s:
            if "phase" in src:  # native build: sort each tile's slots by end
                es, dea, deb, de_sel, de_b0 = runtime.tile_down_phase(*src["phase"], NT, T)
                cd, routers = _coarse_down_arrays(self.coarse.dfs, self._coarse_meta,
                                                  self.n_exit_flat), None
                n_tree, ent_slot, re_sel = src["n_tree"], src["ent_slot"], src["re_sel"]
            else:  # a JAX plan's down tables: replay its chains
                tabs = src["tabs"]

                def flat(name):
                    return np.asarray(tabs[name]).reshape(NT, T)

                es, dea, deb = (_stacked_chain(tabs, p, NT, self.Y) for p in ("es", "dea", "deb"))
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
                    enti = _stacked_chain(tabs, "enti", NT, self.Y)[:, : self.E_pad]
                    ent_slot = np.where(real.reshape(NT, self.E_pad), enti, -1)
        secs["sort phase"] = s.seconds
        with trace.timed("plan.down.compose") as s:
            down_idx = _compose_down(es, dea, deb, de_sel, de_b0, re_sel, n_tree, ent_slot)
        secs["compose"] = s.seconds
        with trace.timed("plan.down.coarse") as s:
            self.coarse.build_down(cd, routers=routers)
        secs["coarse down"] = s.seconds
        self.down_idx = down_idx
        self.down_build_seconds = secs
        self._down_src = None

    def _slab(self, lo, hi, keys):
        """Rows ``lo:hi`` of the per-tile indices ``keys`` (upward or, after
        :meth:`_ensure_down`, downward) on the plan's device, uploaded once
        and kept for later calls on the same slab."""
        cache = self._slabs.setdefault((lo, hi), {})
        for k in keys:
            if k in cache:
                continue
            if k in self.idx:
                cache[k] = _upload_table(k, self.idx[k][lo:hi], self.Y, self.device)
            else:
                cache[k] = self._upload_down(k, slice(lo, hi))
        return {k: cache[k] for k in keys}

    def _shard(self, data, mesh, op):
        """This rank's slab ``(lo, hi)`` of the tile axis, and ``data`` as the
        kernels of the sharded sweep ``op`` take it."""
        H, W = self.shape
        if data.numel() != H * W:
            raise ValueError(f"data must hold {H * W} values")
        if self.NT % mesh.size:
            raise ValueError(f"NT={self.NT} tiles must divide over {mesh.size} devices; pad "
                             "the grid (parallel.build_sharded_plan) so the tile grid splits "
                             "evenly")
        n = self.NT // mesh.size
        x = kernels.cast_in(data, op, kernels._TILE_DTYPES)
        return mesh.rank * n, (mesh.rank + 1) * n, x

    def gather_tiles(self, out, mesh):
        """The whole (H*W,) raster on every rank from each rank's tile stack
        of its slab: one gather in rank order, then raster layout."""
        full, _ = mesh.all_gather(out)
        return kernels._untile(full.reshape(self.NT, -1), self.shape)

    def _tile_of(self, cells):
        """Tile index of padded-grid cell ids."""
        Wp = self.pshape[1]
        ntx = self.grid[1]
        cells = np.asarray(cells, dtype=np.int64)
        return (cells // Wp // self.Y) * ntx + (cells % Wp) // _S

    # -- a JAX plan's tables ----------------------------------------------
    @classmethod
    def from_stage_tables(cls, tabs, cfg, coarse_meta, coarse_dfs, routers=None,
                          down=None, device=None) -> "TilePlan":
        """Build the plan from a JAX ``TilePlan``'s host arrays: ``tabs``
        (its ``_tabs_np``), ``cfg`` (``shape``, ``tile_rows``, ``far_mode``,
        ``b``, ``R_pad``, ``E_pad``, ``has_far``, ``has_entries``),
        ``coarse_meta`` (its ``_coarse_meta``), ``coarse_dfs`` (the coarse
        DFS plan's ``(preorder, pos, size)``) and, for a ``_CoarseRouterSmall``
        or ``BigAccelPlan`` coarse level, ``routers`` (its
        ``router_tables()``, keyed ``"G"`` or ``"G1"``). Each per-tile
        chain is replayed on ``arange`` into the port's composed index.
        ``down`` carries the JAX plan's downward tables for
        :meth:`accumulate_down`: ``tabs`` (its ``_down["tabs"]``), ``cd`` (its
        ``_down["cd"]``) and, for a router coarse level, ``routers`` (its
        ``coarse.down_router_tables()``); without it ``accumulate_down``
        raises. ``tile_rows`` other than 128, 256, 384 or 512 raise
        ValueError."""
        self = cls.__new__(cls)
        secs = {}
        with trace.timed("plan.replay") as s:
            self._config(cfg, device)
            NT, T, Y = self.NT, self.Y * _S, self.Y

            def flat(name):
                return np.asarray(tabs[name]).reshape(NT, T)

            idx = {"rin": _stacked_chain(tabs, "rin", NT, Y)}
            idx["rout"] = np.where(flat("tree_mask") != 0,
                                   _stacked_chain(tabs, "rout", NT, Y), -1).astype(np.int32)
            idx["near_end"] = _near_end(flat("near_sel"), flat("idx_near"), flat("sel_next"))
            idx["far_end"] = np.full((NT, T), -1, np.int32)
            if self.far_mode is not None:
                sig_exp = _stacked_chain(tabs, "fexp", NT, Y)
                sig_far = _stacked_chain(tabs, "ffar", NT, Y)
                if self.far_mode == "router":
                    idx["far_end"] = _far_end_router(sig_exp, sig_far, flat("far_sel"), self.b)
                else:
                    idx["far_end"] = _far_end_packed(
                        sig_exp, sig_far, flat("far_sel"),
                        np.asarray(tabs["far_rlo"])[:, :, 0], np.asarray(tabs["far_rhi"])[:, :, 0],
                        tabs["far_bhi"], tabs["far_bidx"],
                    )
            idx["ex_end"] = np.ascontiguousarray(_stacked_chain(tabs, "ex", NT, Y)[:, : self.R_pad])
            idx["ent_idx"] = np.full((NT, T), -1, np.int32)
            if self.has_entries:
                ent = flat("ent_row").astype(np.int32) * _S + flat("ent_lane").astype(np.int32)
                idx["ent_idx"] = np.where(flat("ent_sel") != 0, ent, -1).astype(np.int32)
        secs["replay"] = s.seconds

        with trace.timed("plan.coarse_plan") as s:
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
                self.coarse = BigAccelPlan(dfs_c, None, routers=routers,
                                           in_slot=coarse_meta["in_slot"],
                                           out_slot=coarse_meta["out_slot"])
        secs["coarse plan"] = s.seconds
        self._down_src = None
        if down is not None:
            self._down_src = {"tabs": down["tabs"], "cd": down["cd"],
                              "routers": down.get("routers"),
                              "n_tree": (flat("tree_mask") != 0).sum(1)}
        self._finish(idx, secs)
        return self

    @classmethod
    def from_indices(cls, cfg, idx, coarse_meta, coarse_dfs, coarse_kind, down_idx=None,
                     coarse_down=None, device=None) -> "TilePlan":
        """The plan from its composed indices, as :meth:`save` writes them:
        ``cfg`` (the geometry and decisions, as :meth:`from_stage_tables`
        takes them), ``idx`` (the six per-tile indices, host arrays or memory
        maps), ``coarse_meta``, ``coarse_dfs`` and ``coarse_kind`` (the
        coarse level's class name; it is rebuilt from its DFS plan) and,
        for :meth:`accumulate_down`, ``down_idx`` and the coarse level's
        composed down indices ``coarse_down``. Nothing is sorted or
        searched."""
        self = cls.__new__(cls)
        with trace.timed("plan.coarse_plan") as s:
            self._config(cfg, device)
            self._coarse_meta = coarse_meta
            self.coarse = self._coarse_level(DfsPlan(*coarse_dfs, device=self.device),
                                             coarse_kind)
        self._down_src = None
        self._finish(idx, {"coarse plan": s.seconds})
        if down_idx is not None:
            self.down_idx = down_idx
            self.coarse.set_down(coarse_down)
        return self

    def save(self, path, down=True):
        """Write the plan to the directory ``path`` (see
        :func:`pyflwdir_torch.ops.plan_io.save_tile_plan`)."""
        from .plan_io import save_tile_plan

        return save_tile_plan(self, path, down=down)

    @staticmethod
    def load(path, mmap=True, device=None) -> "TilePlan":
        """Load a saved plan, the port's or the JAX package's (see
        :func:`pyflwdir_torch.ops.plan_io.load_tile_plan`)."""
        from .plan_io import load_tile_plan

        return load_tile_plan(path, mmap=mmap, device=device)

    # -- execution -----------------------------------------------------------
    def arrays(self):
        """The upward sweep's per-tile device tables (``rin``, ``ex_end``,
        ``ent_idx``, ``near_end``, ``far_end``, ``rout``), for the ``arrs``
        argument of :meth:`accumulate`, as the JAX plan hands its tables to
        a jitted call."""
        return self.idx_t

    def down_arrays(self):
        """The downward sweep's per-tile device tables (``rin`` and ``rout``
        with the down indices), for the ``darrs`` argument of
        :meth:`accumulate_down`; builds the down indices on first use."""
        self._ensure_down()
        t = self.idx_t
        return {"rin": t["rin"], "rout": t["rout"], **self.down_idx_t}

    def accumulate(self, data, arrs=None):
        """Flow accumulation of ``data`` ((H*W,) tensor in raster order on
        the plan's device): tree cells get their subtree sum, missing cells
        pass through. Summed in :func:`~pyflwdir_torch.kernels.sum_dtype`'s
        dtype and returned in ``data``'s. ``arrs``: the tables of
        :meth:`arrays` (None: the plan's own)."""
        H, W = self.shape
        if data.numel() != H * W:
            raise ValueError(f"data must hold {H * W} values")
        with trace.span("up"):
            x = kernels.cast_in(data, "up", kernels._TILE_DTYPES)
            t = self.idx_t if arrs is None else arrs
            with trace.span("T1"):
                exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], self.shape)
            with trace.span("coarse"):
                entv = self.entry_grid(self.coarse.accumulate(exits.reshape(-1)))
            with trace.span("T2"):
                out = kernels.tile_pass_c(x, c, entv, t["ent_idx"], t["near_end"],
                                          t["far_end"], t["rout"], self.shape)
            return kernels.cast_back(out, data.dtype, "up")

    def accumulate_down(self, data, darrs=None):
        """Inclusive downstream-path sum of ``data`` ((H*W,) tensor in raster
        order on the plan's device): ``a[i]`` sums ``data`` over ``i``, its
        downstream cell, ..., its pit; the transpose of :meth:`accumulate`.
        Missing cells pass through. Summed in
        :func:`~pyflwdir_torch.kernels.sum_dtype`'s dtype and returned in
        ``data``'s; integers are exact, and every dtype gives the same bits
        from run to run. float32 data goes to T3 and T4 as it is, with no
        copy either way (``down.fused``): they sum it in float64 and round
        each result once, the bits of the float64 sweep of its cast.
        ``darrs``: the tables of :meth:`down_arrays` (None: the plan's own)."""
        H, W = self.shape
        if data.numel() != H * W:
            raise ValueError(f"data must hold {H * W} values")
        with trace.span("down"):
            d = self.down_arrays() if darrs is None else darrs
            x = kernels.cast_in(data, "down", kernels._DOWN_DTYPES)
            d1 = (d["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
            if self.has_entries and self.coarse.dfs.n_tree > 0:
                # raw D1: routing and passthrough wait for D2
                with trace.span("T3"):
                    z, pk = kernels.tile_down_a(x, *d1, None, self.shape, False)
                with trace.span("coarse"):
                    A = self.coarse.accumulate_down(pk.reshape(-1))
                with trace.span("T4"):
                    out = kernels.tile_down_fin(x, z, A.reshape(self.NT, self.R_pad),
                                                d["tree_of"], d["rout"], self.shape)
            else:
                with trace.span("T3"):
                    out, _ = kernels.tile_down_a(x, *d1, d["rout"], self.shape, True)
            return kernels.cast_back(out, data.dtype, "down")

    def accumulate_sharded(self, data, mesh, overlap_chunks=2):
        """:meth:`accumulate` sharded over the ranks of ``mesh``
        (:class:`pyflwdir_torch.parallel.Mesh`), each running its slab of
        ``NT / size`` tiles: pass A (T1 on the slab's tile range, in
        ``overlap_chunks`` chunks, each chunk's exits gathered
        asynchronously while the next chunk runs; the count drops until it
        divides the slab), the coarse level on every rank on the gathered
        exits, pass C (T2) resuming from the slab's prefix sums with its
        rows of the entry values, and one gather of the result.

        ``data``: the whole (H*W,) raster on every rank, on the plan's
        device. Returns the whole (H*W,) result on every rank in ``data``'s
        dtype, bitwise equal to :meth:`accumulate`'s. Each rank keeps its
        slab's rows of the indices on the device, never the whole tables.
        Raises ValueError where the tiles do not divide over the ranks."""
        lo, hi, x = self._shard(data, mesh, "up")
        C = max(int(overlap_chunks), 1)
        while (hi - lo) % C:
            C -= 1
        n = (hi - lo) // C
        t = self._slab(lo, hi, ("rin", "ex_end", "ent_idx", "near_end", "far_end", "rout"))
        cs, gathered = [], []
        for k in range(C):
            rows = slice(k * n, (k + 1) * n)
            ex, c = kernels.tile_pass_a(x, t["rin"][rows], t["ex_end"][rows], self.shape,
                                        tile0=lo + k * n)
            cs.append(c)
            gathered.append(mesh.all_gather(ex, async_op=True))
        for _, work in gathered:
            if work is not None:
                work.wait()
        # (rank, chunk, tile) is the plan's tile order
        exits = gathered[0][0] if C == 1 else torch.stack([g for g, _ in gathered], 1)
        entv = self.entry_grid(self.coarse.accumulate(exits.reshape(-1)))[lo:hi]
        out = kernels.tile_pass_c(x, cs[0] if C == 1 else torch.cat(cs), entv, t["ent_idx"],
                                  t["near_end"], t["far_end"], t["rout"], self.shape, tile0=lo)
        return kernels.cast_back(self.gather_tiles(out, mesh), data.dtype, "up")

    def accumulate_down_sharded(self, data, mesh):
        """:meth:`accumulate_down` sharded over the ranks of ``mesh``, as
        :meth:`accumulate_sharded`: pass D1 (T3 routed on the slab's tile
        range), then, where the plan has entry cells and coarse trees, one
        gather of the packed entry values, the coarse downward solve on
        every rank, and pass D2 (T4 in lite mode: each tree cell adds its
        tree's continuation); one gather of the result. Returns the whole
        (H*W,) result on every rank in ``data``'s dtype, bitwise equal to
        :meth:`accumulate_down`'s."""
        self._ensure_down()
        lo, hi, x = self._shard(data, mesh, "down")
        t = self._slab(lo, hi, ("rin", "es", "g_last", "g_prev", "n_tree", "ent_slot", "rout"))
        abar, pk = kernels.tile_down_a(x, t["rin"], t["es"], t["g_last"], t["g_prev"],
                                       t["n_tree"], t["ent_slot"], t["rout"], self.shape,
                                       True, tile0=lo)
        if self.has_entries and self.coarse.dfs.n_tree > 0:
            pk_all, _ = mesh.all_gather(pk)
            A = self.coarse.accumulate_down(pk_all.reshape(-1)).reshape(self.NT, self.R_pad)
            tree_of = self._slab(lo, hi, ("tree_of",))["tree_of"]
            abar = kernels.tile_down_lite(abar, A[lo:hi], tree_of, t["rout"], self.shape,
                                          tile0=lo)
        return kernels.cast_back(self.gather_tiles(abar, mesh), data.dtype, "down")

    def _banded_dtypes(self, data2d, band_rows):
        """(result dtype, sum dtype) of a banded call: the port's rule
        (:func:`~pyflwdir_torch.kernels.sum_dtype`), with ``|max|`` of
        64-bit integer data found band by band on the host; unit weights
        take the rule's bool case."""
        n = self.shape[0] * self.shape[1]
        if data2d is None:
            acc = kernels.sum_dtype(torch.bool, n, None)
            return acc, acc
        dtype = torch.from_numpy(np.empty(0, data2d.dtype)).dtype
        bands = (np.asarray(data2d[r0: r0 + band_rows])
                 for r0 in range(0, self.shape[0], band_rows))
        return dtype, kernels.sum_dtype(
            dtype, n, lambda: max(max(-int(b.min()), int(b.max())) for b in bands if b.size))

    def accumulate_banded(self, data2d, band_tile_rows=None, out_cb=None):
        """Flow accumulation band by band, for plans whose indices do not fit
        the device: pass A (kernel T1, exits only) runs band by band with
        only that band's slices of ``rin`` and ``ex_end`` on the device, the
        coarse level solves once, then pass C (T2 in full mode) runs band by
        band with that band's ``rin``, ``ent_idx``, ``near_end``,
        ``far_end`` and ``rout``. A band is ``band_tile_rows`` rows of tiles
        (all of them where None). The indices are never uploaded whole.

        ``data2d``: an (H, W) array or ``np.memmap``, read band by band (twice;
        64-bit integer data once more beforehand, for the sum dtype), or
        None for unit weights made on the device.
        Each band's result reaches the host after the next band's pass C is
        enqueued; with ``out_cb`` it goes to ``out_cb(band, first_row,
        array)`` in band order (``array`` of shape (rows, W)) and the call
        returns None, else the call returns the assembled (H, W) array.
        Results come in the data's dtype (int32 for unit weights), equal to
        :meth:`accumulate`'s."""
        H, W = self.shape
        nty, ntx = self.grid
        btr = nty if band_tile_rows is None else int(band_tile_rows)
        if btr < 1:
            raise ValueError("band_tile_rows must be at least 1")
        if data2d is not None and tuple(data2d.shape) != (H, W):
            raise ValueError(f"data2d must be of shape {(H, W)}")
        bands = [(ty0, min(ty0 + btr, nty)) for ty0 in range(0, nty, btr)]
        dtype, acc = self._banded_dtypes(data2d, btr * self.Y)
        dev = self.device

        def band(ty0, ty1, keys):
            r0, r1 = ty0 * self.Y, min(ty1 * self.Y, H)
            if data2d is None:
                x = torch.ones((r1 - r0) * W, dtype=acc, device=dev)
            else:
                x = kernels.cast_in(_upload(data2d[r0:r1], dev), "up", kernels._TILE_DTYPES, acc)
            t = {k: tile_table(self.idx[k][ty0 * ntx: ty1 * ntx], self.Y, dev) for k in keys}
            return r0, (r1 - r0, W), x, t

        # each band's tensors are dropped before the next band's upload
        exits = []
        for ty0, ty1 in bands:
            _, shape, x, t = band(ty0, ty1, ("rin", "ex_end"))
            exits.append(kernels.tile_pass_a(x, t["rin"], t["ex_end"], shape, emit_c=False))
            del x, t
        entv = self.entry_grid(self.coarse.accumulate(torch.cat(exits).reshape(-1)))
        del exits

        sink = _BandSink((H, W), out_cb, dev)
        for b, (ty0, ty1) in enumerate(bands):
            r0, shape, x, t = band(ty0, ty1, ("rin", "ent_idx", "near_end", "far_end", "rout"))
            out = kernels.tile_pass_c(x, None, entv[ty0 * ntx: ty1 * ntx], t["ent_idx"],
                                      t["near_end"], t["far_end"], t["rout"], shape,
                                      rin=t["rin"])
            del x, t
            sink.put(b, r0, kernels.cast_back(out, dtype, "up").reshape(shape))
            del out
        return sink.finish()

    def entry_grid(self, entv):
        """The coarse level's entry values (out_slot layout) as the
        (NT, E_pad) grid pass C reads, zero padded."""
        n = self.NT * self.E_pad
        if entv.numel() < n:
            entv = torch.cat([entv, entv.new_zeros(n - entv.numel())])
        return entv[:n].reshape(self.NT, self.E_pad)


def build_tile_plan(idxs_ds_np, shape, tile_rows=128, device=None) -> TilePlan:
    """Build a :class:`TilePlan` of ``tile_rows``-row tiles (128, 256, 384 or
    512) for a raster graph on ``device``.

    Raises ValueError where the JAX package's build raises (another
    ``tile_rows``, a coarse graph past ``BigAccelPlan``'s 2^28 slots, entry
    rows past its int8 row table); the methods of
    :class:`pyflwdir_torch.raster.FlwdirRaster` pass the error on."""
    return TilePlan(idxs_ds_np, shape, tile_rows=tile_rows, device=device)
