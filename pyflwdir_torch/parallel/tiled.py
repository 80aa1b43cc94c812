"""Multi-device runtime on ``torch.distributed``: the mesh, the halo runtime
and the sharded tile plan.

A :class:`Mesh` is the ranks of a process group (one device each) laid out
as a 2-D ("ty", "tx") grid, as the JAX package's ``make_mesh`` lays out its
devices. Rank r owns block (r // tx, r % tx) of the grid padded to the mesh
(:func:`pad_to_tiles`). NCCL joins ranks on CUDA, gloo on the CPU
(:func:`pyflwdir_torch.parallel.init_distributed`).

The halo runtime is the port of the JAX package's ``shard_map`` bodies:
each rank derives its block's tile-local graph (:mod:`pyflwdir_torch.ops.
stencil`), solves what stays inside the block with pointer doubling
(:mod:`pyflwdir_torch.ops.graph`) and trades the values on its edges with
its neighbours (:meth:`Mesh.gather_halo`, :meth:`Mesh.exchange_halo`: rows
first, then the columns of the updated buffer, so corner values ride two
hops). The JAX ``lax.while_loop`` fixpoints are host loops that end when
one ``all_reduce`` of the changed count (:meth:`Mesh.psum`) reads 0; their
round counts stand in :data:`last_rounds`. :func:`tiled_fill` runs kernel
F1 (:func:`pyflwdir_torch.kernels.fill_sweep`) on each rank's framed
block; the rest is plain PyTorch, as its JAX source is plain XLA.

:func:`tiled_accumulate` with ``method="plan"`` shards a hierarchical
:class:`~pyflwdir_torch.ops.tile_plan.TilePlan` instead
(:meth:`TilePlan.accumulate_sharded`): every rank runs kernels T1 and T2 on
its contiguous slab of tiles, with one gather of the per-tile exit records
between them.

Every function takes the whole input on every rank and returns the whole
result there, as numpy of the input's shape.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from .._backend import resolve_device
from ..ops.graph import _scatter, _subtree_reduce, path_sum, reach
from ..ops.stencil import local_pointers

__all__ = [
    "Mesh",
    "make_mesh",
    "build_sharded_plan",
    "pad_to_tiles",
    "tiled_accumulate",
    "tiled_rank",
    "tiled_basins",
    "tiled_fill",
    "tiled_stream_distance",
    "tiled_hand",
    "tiled_strahler",
    "last_rounds",
]

#: round counts of the last calls: the halo rounds of the last
#: ``tiled_accumulate(method="iterate")`` (``"accumulate"``), ``tiled_rank``,
#: ``tiled_basins``, ``tiled_stream_distance`` and ``tiled_hand``;
#: ``"fill"`` the sweep rounds of the last :func:`tiled_fill` summed over its
#: fills and ``"depth"`` its outer rounds under ``max_depth >= 0``;
#: ``"strahler"`` the order levels the last :func:`tiled_strahler`
#: accumulated. A count equal to ``max_rounds`` means the loop stopped there.
last_rounds = {"accumulate": 0, "rank": 0, "basins": 0, "stream_distance": 0, "hand": 0,
               "fill": 0, "depth": 0, "strahler": 0}


def _grid_shape(n):
    """(ty, tx) with ty * tx == n, as square as n allows."""
    ty = int(np.floor(np.sqrt(n)))
    while n % ty:
        ty -= 1
    return ty, n // ty


class Mesh:
    """The ranks a sharded call runs on.

    ``group``: the ``torch.distributed`` process group (None for a single
    process that started none); ``rank`` and ``size``: this process's rank
    in it and its size; ``shape``: the (ty, tx) layout of the ranks,
    row-major; ``device``: this rank's device."""

    def __init__(self, group, rank, size, shape, device):
        self.group, self.rank, self.size = group, int(rank), int(size)
        self.shape = tuple(int(v) for v in shape)
        self.device = torch.device(device)
        self._p2p_ready = False

    def __repr__(self):
        return f"Mesh(rank={self.rank}, size={self.size}, shape={self.shape}, device={self.device})"

    @property
    def coords(self):
        """This rank's block (ti, tj) of the mesh."""
        return divmod(self.rank, self.shape[1])

    def all_gather(self, t, async_op=False):
        """Every rank's ``t`` (one shape on all ranks), stacked in rank order:
        returns ``(out, work)``, ``out`` of shape ``(size, *t.shape)`` and
        ``work`` None or, where ``async_op``, a handle whose ``wait()`` makes
        the current stream wait for the gather."""
        out = torch.empty((self.size, *t.shape), dtype=t.dtype, device=t.device)
        if self.group is None:
            out[0].copy_(t)
            return out, None
        # the one gather of one flat tensor that both torch 2.11 and later
        # versions have (later ones warn that it is deprecated)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            work = dist.all_gather_into_tensor(out.reshape(-1), t.contiguous().reshape(-1),
                                               group=self.group, async_op=async_op)
        return out, work

    def psum(self, x):
        """The sum of the 0-d tensor ``x`` over the ranks (one ``all_reduce``),
        read to the host as a Python number on every rank."""
        t = x.reshape(1).clone()
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t.item()

    def _neighbour(self, dy, dx):
        """The group rank of the block ``(dy, dx)`` from this one, None off
        the mesh."""
        ti, tj = self.coords
        ti, tj = ti + dy, tj + dx
        if 0 <= ti < self.shape[0] and 0 <= tj < self.shape[1]:
            return ti * self.shape[1] + tj
        return None

    def _swap(self, pairs):
        """Point-to-point exchange with the neighbours: ``pairs`` holds
        ``(send, recv, peer)``, the contiguous tensor sent to and the buffer
        received from the block ``peer`` = (dy, dx) away; a pair whose peer
        lies off the mesh posts nothing. One ``batch_isend_irecv`` between
        true neighbours only: no edge crosses the mesh's border, and a
        one-rank mesh does no P2P at all."""
        ops = []
        for send, recv, (dy, dx) in pairs:
            peer = self._neighbour(dy, dx)
            if peer is None:
                continue
            if self.group is not dist.group.WORLD:
                peer = dist.get_global_rank(self.group, peer)
            ops.append(dist.P2POp(dist.isend, send, peer, group=self.group))
            ops.append(dist.P2POp(dist.irecv, recv, peer, group=self.group))
        if not ops:
            return
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    def _p2p_start(self):
        """Before the first P2P call of a group with more than one rank, one
        collective of every rank (NCCL's first P2P call wants them all)."""
        if self.size > 1 and not self._p2p_ready:
            self.psum(torch.zeros((), dtype=torch.int64, device=self.device))
            self._p2p_ready = True

    def gather_halo(self, v2d, fill):
        """The (th+2, tw+2) frame of the block ``v2d``: its centre ``v2d``,
        its border the neighbours' edge values, ``fill`` at the mesh's
        border (the JAX package's ``_gather_halo``). Rows first along "ty";
        then the edge columns, the received rows' corners included, along
        "tx": corner values ride two hops."""
        self._p2p_start()
        th, tw = v2d.shape
        frame = torch.empty((th + 2, tw + 2), dtype=v2d.dtype, device=v2d.device)
        frame[1:-1, 1:-1] = v2d
        top, bot = frame[0, 1:-1], frame[-1, 1:-1]
        top.fill_(fill)
        bot.fill_(fill)
        # my top row goes up and becomes that block's bottom halo row
        self._swap([(v2d[0].contiguous(), top, (-1, 0)),
                    (v2d[-1].contiguous(), bot, (1, 0))])
        col_l = torch.full((th + 2,), fill, dtype=v2d.dtype, device=v2d.device)
        col_r = col_l.clone()
        self._swap([(frame[:, 1].contiguous(), col_l, (0, -1)),
                    (frame[:, -2].contiguous(), col_r, (0, 1))])
        frame[:, 0] = col_l
        frame[:, -1] = col_r
        return frame

    def exchange_halo(self, out_pad):
        """The flows the neighbours send into this block, added to the
        interior of ``out_pad`` (a (th+2, tw+2) buffer whose border holds
        this block's flows out, by target cell), as a (th, tw) array (the
        JAX package's ``_exchange_halo``). Phase 1 ships the top and bottom
        border rows (full width, corners included) along "ty"; phase 2 the
        border columns of the updated buffer along "tx": corner flows ride
        two hops. Off the mesh nothing arrives (flows leaving the grid were
        cut before)."""
        self._p2p_start()
        rb = torch.zeros_like(out_pad[0])  # from the block below
        ra = torch.zeros_like(out_pad[0])  # from the block above
        # my top border row goes up: it targets that block's bottom row
        self._swap([(out_pad[0].contiguous(), ra, (-1, 0)),
                    (out_pad[-1].contiguous(), rb, (1, 0))])

        def col(c, rb_c, ra_c):
            c = c.clone()
            c[0] = 0
            c[-1] = 0
            c[-2] += rb_c
            c[1] += ra_c
            return c

        rr = torch.zeros_like(out_pad[:, 0])  # from the block on the right
        rl = torch.zeros_like(out_pad[:, 0])  # from the block on the left
        self._swap([(col(out_pad[:, 0], rb[0], ra[0]), rl, (0, -1)),
                    (col(out_pad[:, -1], rb[-1], ra[-1]), rr, (0, 1))])
        interior = out_pad[1:-1, 1:-1].clone()
        interior[-1] += rb[1:-1]
        interior[0] += ra[1:-1]
        interior[:, -1] += rr[1:-1]
        interior[:, 0] += rl[1:-1]
        return interior


def _rank_device(device, rank):
    """This rank's device: ``device``, with ``cuda`` taken as the local
    rank's card; None means the card (raising without one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """A :class:`Mesh` of the first ``n_devices`` ranks of the process group
    (all of them where None; one rank where no group was started), laid out
    (ty, tx) as square as the count allows. Each rank takes the card of its
    local rank unless ``device`` names another (``"cpu"`` for gloo); with
    no GPU and no ``device`` it raises. Fewer ranks than the world make a
    subgroup, which every rank must create: ranks outside it get None."""
    started = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if started else (1, 0)
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices}: the world has {world} ranks")
    group = None
    if started:
        group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group, rank, n, _grid_shape(n), _rank_device(device, rank))


def pad_to_tiles(arr: np.ndarray, mesh: Mesh, fill):
    """Pad a 2-D array so both dims divide by the mesh tiling."""
    ty, tx = mesh.shape
    nrow, ncol = arr.shape
    pr = (-nrow) % ty
    pc = (-ncol) % tx
    if pr or pc:
        arr = np.pad(arr, ((0, pr), (0, pc)), constant_values=fill)
    return arr


def build_sharded_plan(codes: np.ndarray, mesh: Mesh, tile_rows: int = 128):
    """Build a :class:`~pyflwdir_torch.ops.tile_plan.TilePlan` of
    ``tile_rows``-row tiles (128, 256, 384 or 512; another raises ValueError)
    on the rank's device whose tile grid splits evenly over ``mesh``: the D8
    ``codes`` padded with nodata to whole tile-row slabs per rank (rows to a
    multiple of ``tile_rows * size``, columns to 128), as the JAX package pads
    them, so the two build the same graph. Returns ``(plan, pshape)``,
    ``pshape`` the padded shape the plan runs on."""
    from ..codecs import d8 as d8c
    from ..ops.tile_plan import _tile_rows, build_tile_plan

    tile_rows = _tile_rows(tile_rows)
    pr = (-codes.shape[0]) % (tile_rows * mesh.size)
    pc = (-codes.shape[1]) % 128
    codes_p = np.pad(np.asarray(codes), ((0, pr), (0, pc)), constant_values=247)
    idxs_ds = d8c.from_array(codes_p)[0]
    return (build_tile_plan(idxs_ds, codes_p.shape, tile_rows=tile_rows, device=mesh.device),
            codes_p.shape)


# ---------------------------------------------------------------------------
# the halo runtime: one rank's block
# ---------------------------------------------------------------------------
_UNSET = -1e30  # float carry sentinel (below any physical value)


def _block(arr, mesh, fill):
    """This rank's block of ``arr`` padded to the mesh (``fill``), as a
    tensor on the rank's device, and the padded shape."""
    a = pad_to_tiles(np.asarray(arr), mesh, fill)
    ty, tx = mesh.shape
    th, tw = a.shape[0] // ty, a.shape[1] // tx
    ti, tj = mesh.coords
    blk = np.ascontiguousarray(a[ti * th:(ti + 1) * th, tj * tw:(tj + 1) * tw])
    return torch.as_tensor(blk, device=mesh.device), a.shape


def _gather_grid(blk, mesh):
    """The whole padded grid on every rank from each rank's (th, tw) block:
    one gather in rank order (a tensor on the rank's device)."""
    full, _ = mesh.all_gather(blk.contiguous())
    (ty, tx), (th, tw) = mesh.shape, blk.shape
    return full.reshape(ty, tx, th, tw).permute(0, 2, 1, 3).reshape(ty * th, tx * tw)


def _result(blk, mesh, shape):
    """The whole result as numpy, cropped to the input's ``shape``."""
    return _gather_grid(blk, mesh).cpu().numpy()[: shape[0], : shape[1]]


def _check_converged(stalled, what):
    if stalled:
        raise RuntimeError(
            f"tiled {what} did not converge within max_rounds — raise "
            "max_rounds, or the network has cross-tile cycles"
        )


def _kill_off_grid_exits(exit_dr, exit_dc, mesh):
    """Zero the exit steps of cells whose flow leaves the global grid
    (they parse as pits in ``codecs.d8.from_array``)."""
    th, tw = exit_dr.shape
    ti, tj = mesh.coords
    nty, ntx = mesh.shape
    r = torch.arange(th, device=exit_dr.device)[:, None]
    c = torch.arange(tw, device=exit_dr.device)[None, :]
    off_grid = (((ti == 0) & (r == 0) & (exit_dr < 0))
                | ((ti == nty - 1) & (r == th - 1) & (exit_dr > 0))
                | ((tj == 0) & (c == 0) & (exit_dc < 0))
                | ((tj == ntx - 1) & (c == tw - 1) & (exit_dc > 0)))
    zero = torch.zeros_like(exit_dr)
    return torch.where(off_grid, zero, exit_dr), torch.where(off_grid, zero, exit_dc)


def _graph(codes_t, mesh):
    """The block's tile-local graph: ``local_pointers`` with the steps off
    the global grid cut."""
    local_ds, exit_dr, exit_dc, valid = local_pointers(codes_t)
    exit_dr, exit_dc = _kill_off_grid_exits(exit_dr, exit_dc, mesh)
    return local_ds, exit_dr, exit_dc, valid


def _local_accumulate(local_ds, data_flat):
    """Tile-local subtree sums (doubling on the cut graph): integers by
    ``index_add_``, floats by ``graph._sum_by_target`` (the same bits from
    call to call)."""
    n = local_ds.shape[0]
    ar = torch.arange(n, dtype=local_ds.dtype, device=local_ds.device)
    ptr = torch.where(local_ds != ar, local_ds, torch.full_like(local_ds, n))
    return _subtree_reduce(ptr, data_flat, "add")


def _terminals(local_ds, exit_dr, exit_dc, valid):
    """Each cell's local terminal (the last in-block cell of its path):
    ``(term, absorb, exit_term, hidx)``: the terminal, whether it is a pit
    (or cut cell) of the block, whether it leaves the block, and the flat
    index into the (th+2, tw+2) halo frame of the cell past it."""
    th, tw = valid.shape
    vflat = valid.reshape(-1)
    term = reach(local_ds, None)
    true_root = local_ds[term] == term  # a genuine pit or exit, not a cycle
    t_dr = exit_dr.reshape(-1)[term]
    t_dc = exit_dc.reshape(-1)[term]
    leaves = (t_dr != 0) | (t_dc != 0)
    term_r = torch.div(term, tw, rounding_mode="floor") + 1 + t_dr
    term_c = term % tw + 1 + t_dc
    return (term, vflat & true_root & ~leaves, vflat & true_root & leaves,
            term_r * (tw + 2) + term_c)


def _fixpoint(codes_t, seed_t, mode, max_rounds, mesh):
    """The cross-block pointer fixpoint (the JAX ``_fixpoint_step``): rank
    (``mode`` "rank") or basin labels ("label"). A cell's value depends only
    on its local terminal plus the value just across the block's edge;
    rounds trade edge values until no rank changes one. Returns the block's
    int32 values, whether the loop stalled, and the rounds."""
    th, tw = codes_t.shape
    local_ds, exit_dr, exit_dc, valid = _graph(codes_t, mesh)
    vflat = valid.reshape(-1)
    term, pit_term, exit_term, hidx = _terminals(local_ds, exit_dr, exit_dc, valid)
    dist_ = path_sum(local_ds, torch.ones(th * tw, dtype=torch.int32, device=mesh.device))
    if mode == "rank":
        unset = -1
        v = torch.where(pit_term, dist_, -1).to(torch.int32)
    else:
        unset = 0
        v = torch.where(pit_term, seed_t.reshape(-1).to(torch.int32)[term], 0).to(torch.int32)
    rounds, changed = 0, 1
    while rounds < max_rounds and changed > 0:
        tv = mesh.gather_halo(v.reshape(th, tw), unset).reshape(-1)[hidx]
        if mode == "rank":
            v_new = torch.where(exit_term & (v < 0) & (tv >= 0), dist_ + 1 + tv, v)
        else:
            v_new = torch.where(exit_term & (v == 0) & (tv > 0), tv, v)
        v_new = v_new.to(torch.int32)
        changed = mesh.psum((v_new != v).sum())
        v = v_new
        rounds += 1
    if mode == "rank":
        v = torch.where(vflat, v, -9999).to(torch.int32)
    return v.reshape(th, tw), changed > 0, rounds


def _carry(codes_t, seed_t, w_t, cut_t, mode, max_rounds, mesh):
    """Float cross-block carries (the JAX ``_carry_step``), float32. Mode
    "dist": the path length to the nearest absorbing cell (a pit or a
    ``cut`` cell) with step weights ``w`` (``w[i]`` the length of the step
    from i); mode "flabel": the value of ``seed`` at the nearest downstream
    ``cut`` cell (else the pit). Cells that reach no absorber keep
    ``_UNSET``. Returns the block's values, whether the loop stalled, and
    the rounds."""
    th, tw = codes_t.shape
    n = th * tw
    local_ds, exit_dr, exit_dc, valid = _graph(codes_t, mesh)
    vflat = valid.reshape(-1)
    if cut_t is not None:
        ar = torch.arange(n, dtype=local_ds.dtype, device=local_ds.device)
        local_ds = torch.where(cut_t.reshape(-1) & vflat, ar, local_ds)
        zero = torch.zeros_like(exit_dr)
        exit_dr = torch.where(cut_t, zero, exit_dr)
        exit_dc = torch.where(cut_t, zero, exit_dc)
    term, absorb, exit_term, hidx = _terminals(local_ds, exit_dr, exit_dc, valid)
    unset = torch.tensor(_UNSET, dtype=torch.float32, device=mesh.device)
    zero = torch.zeros((), dtype=torch.float32, device=mesh.device)
    if mode == "dist":
        wflat = torch.where(vflat, w_t.reshape(-1).to(torch.float32), zero)
        pw = path_sum(local_ds, wflat)
        wcross = torch.where(exit_term, wflat[term], zero)
        v = torch.where(absorb, pw, unset)
    else:
        v = torch.where(absorb, seed_t.reshape(-1).to(torch.float32)[term], unset)
    rounds, changed = 0, 1
    while rounds < max_rounds and changed > 0:
        tv = mesh.gather_halo(v.reshape(th, tw), _UNSET).reshape(-1)[hidx]
        live = exit_term & (v == unset) & (tv != unset)
        v_new = torch.where(live, pw + wcross + tv if mode == "dist" else tv, v)
        changed = mesh.psum((v_new != v).sum())
        v = v_new
        rounds += 1
    return v.reshape(th, tw), changed > 0, rounds


def _exit_slots(th, tw):
    """Exit slots of a (th, tw) block: one a border cell, as the JAX package
    counts them (``K = 2 (th + tw)``), at most one a cell."""
    return min(2 * (th + tw), th * tw)


class _CoarseBlock:
    """One rank's part of the hierarchical (constant-round) accumulation,
    the JAX ``_tile_step_coarse``: the block's exit cells compacted into
    ``K = 2 (th + tw)`` slots in index order; one :meth:`Mesh.gather_halo`
    of the coarse slot of each cell's local root. :meth:`accumulate` then
    takes the block's local subtree sums, one :meth:`Mesh.all_gather` of
    the four per-slot records (parent slot, destination block, entry cell,
    value), solves the coarse forest on every rank and finishes with one
    local injection pass: two collectives a call, whatever the path
    lengths. Made once per code raster, so that the order levels of
    :func:`tiled_strahler` share it. Raises RuntimeError where a block has
    more exit cells than slots."""

    def __init__(self, codes_t, mesh):
        th, tw = codes_t.shape
        n = th * tw
        dev = mesh.device
        self.mesh, self.n = mesh, n
        self.local_ds, exit_dr, exit_dc, self.valid = _graph(codes_t, mesh)
        vflat = self.valid.reshape(-1)
        K = _exit_slots(th, tw)
        is_exit = ((exit_dr != 0) | (exit_dc != 0)).reshape(-1) & vflat
        # the exit cells in index order, then non-exit cells as junk slots
        # (the first K of the JAX package's argsort of unique keys)
        ex = torch.nonzero(is_exit).reshape(-1)
        n_ex = ex.numel()
        if mesh.psum(torch.tensor(max(n_ex - K, 0), device=dev)) > 0:
            raise RuntimeError("tiled accumulation: exit cells exceed K slots")
        if n_ex < K:
            ex = torch.cat([ex, torch.nonzero(~is_exit).reshape(-1)[: K - n_ex]])
        self.exit_cells = ex
        slots = torch.arange(K, dtype=torch.int64, device=dev)
        self.slot_valid = slots < n_ex
        slot_of_cell = torch.full((n,), -1, dtype=torch.int64, device=dev)
        slot_of_cell[ex[:n_ex]] = slots[:n_ex]
        ti, tj = mesh.coords
        nty, ntx = mesh.shape
        self.my_lin, self.K = ti * ntx + tj, K
        # the coarse slot of each cell's local root (-1 where pit-rooted), global
        root_slot = slot_of_cell[reach(self.local_ds, None)]
        gslot = torch.where(root_slot >= 0, self.my_lin * K + root_slot, -1)
        halo = mesh.gather_halo(gslot.reshape(th, tw), -1).reshape(-1)
        er = torch.div(ex, tw, rounding_mode="floor")
        ec = ex % tw
        sdr = exit_dr.reshape(-1)[ex].long()
        sdc = exit_dc.reshape(-1)[ex].long()
        parent = halo[(er + 1 + sdr) * (tw + 2) + ec + 1 + sdc]  # gslot of the entry's root
        self.parent = torch.where(self.slot_valid & (parent >= 0), parent, self.my_lin * K + slots)
        gr = ti * th + er + sdr
        gc = tj * tw + ec + sdc
        dest = (torch.div(gr, th, rounding_mode="floor") * ntx
                + torch.div(gc, tw, rounding_mode="floor"))
        self.dest = torch.where(self.slot_valid, dest, -1)
        self.entry = (gr % th) * tw + gc % tw

    def accumulate(self, data_t):
        """The block of the accumulation of ``data_t`` (the block's data:
        integers or float64), in ``data_t``'s dtype."""
        mesh, n = self.mesh, self.n
        vflat = self.valid.reshape(-1)
        data = data_t.reshape(-1)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        accu_local = _local_accumulate(self.local_ds, torch.where(vflat, data, zero))
        sval = torch.where(self.slot_valid, accu_local[self.exit_cells], zero)
        bits = sval.view(torch.int64) if sval.dtype == torch.float64 else sval.long()
        rec, _ = mesh.all_gather(torch.stack([self.parent, self.dest, self.entry, bits]))
        g_parent, g_dest, g_entry, g_bits = (rec[:, k].reshape(-1) for k in range(4))
        g_s = g_bits.view(torch.float64) if sval.dtype == torch.float64 else g_bits.to(sval.dtype)
        # the coarse forest, solved on every rank
        m = g_parent.numel()
        arm = torch.arange(m, dtype=torch.int64, device=data.device)
        A = _subtree_reduce(torch.where(g_parent != arm, g_parent, m), g_s, "add")
        # inject the incoming totals at my entry cells and finish locally
        tgt = torch.where(g_dest == self.my_lin, g_entry, n)
        inj = torch.where(vflat, _scatter(tgt, A, n, "add"), zero)
        total = accu_local + _local_accumulate(self.local_ds, inj)
        return torch.where(vflat, total, data).reshape(self.valid.shape)


def _iterate(codes_t, data_t, max_rounds, mesh):
    """Local accumulation plus iterated cross-block injection (the JAX
    ``_tile_step``): each round scatters the exit flows into a (th+2, tw+2)
    frame, ships it (:meth:`Mesh.exchange_halo`) and propagates what
    arrived down the block, until no rank has flow in flight (one
    ``all_reduce`` of the pending flow a round). Returns the block's
    result, whether the loop stalled, and the rounds."""
    th, tw = codes_t.shape
    local_ds, exit_dr, exit_dc, valid = _graph(codes_t, mesh)
    vflat = valid.reshape(-1)
    data = data_t.reshape(-1)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    accu = _local_accumulate(local_ds, torch.where(vflat, data, zero))
    is_exit = ((exit_dr != 0) | (exit_dc != 0)).reshape(-1)
    r = torch.arange(th, device=mesh.device)[:, None]
    c = torch.arange(tw, device=mesh.device)[None, :]
    nf = (th + 2) * (tw + 2)
    flat = ((r + 1 + exit_dr) * (tw + 2) + c + 1 + exit_dc).reshape(-1)
    flat = torch.where(is_exit, flat, nf)

    def pending(flow):
        return mesh.psum(torch.where(is_exit, flow.abs(), zero).sum())

    total = inject = accu
    rounds = 0
    p = pending(inject)
    while rounds < max_rounds and p > 0:
        out_pad = _scatter(flat, torch.where(is_exit, inject, zero), nf, "add")
        received = mesh.exchange_halo(out_pad.reshape(th + 2, tw + 2))
        inject = _local_accumulate(local_ds, torch.where(vflat, received.reshape(-1), zero))
        total = total + inject
        rounds += 1
        p = pending(inject)
    return torch.where(vflat, total, data).reshape(th, tw), p > 0, rounds


# ---------------------------------------------------------------------------
# the public functions
# ---------------------------------------------------------------------------
def tiled_accumulate(codes: np.ndarray, data: np.ndarray, mesh: Mesh,
                     max_rounds: int | None = None, method: str = "coarse"):
    """Flow accumulation of ``data`` over a D8 code raster, sharded over
    ``mesh``; returns the dense float32 grid of the input's shape, equal to
    ``graph.accumulate`` on the parsed graph. The data go in as float32,
    sum in float64 and come back as float32 (the JAX package sums in
    float32): integer-valued data with sums below 2^24 agree bitwise.

    ``method="coarse"`` (the default) solves cross-block flow
    hierarchically: two collectives whatever the path lengths
    (:class:`_CoarseBlock`). ``"iterate"`` is the halo fixpoint, a round a
    block crossing of the longest path (``max_rounds``, by default the cell
    count, raises RuntimeError where it stalls). ``"plan"`` shards a tile
    plan over the mesh (:func:`build_sharded_plan`,
    :meth:`TilePlan.accumulate_sharded`)."""
    if method not in ("coarse", "iterate", "plan"):
        raise ValueError(f'unknown method "{method}"')
    nrow0, ncol0 = codes.shape
    if method == "plan":
        tp, pshape = build_sharded_plan(codes, mesh)
        data_p = np.zeros(pshape, dtype=np.float32)
        data_p[:nrow0, :ncol0] = np.asarray(data, dtype=np.float32)
        out = tp.accumulate_sharded(torch.as_tensor(data_p.ravel(), device=mesh.device), mesh)
        return out.cpu().numpy().reshape(pshape)[:nrow0, :ncol0]
    codes_t, pshape = _block(codes, mesh, 247)
    data_t = _block(np.asarray(data, dtype=np.float32), mesh, 0.0)[0].to(torch.float64)
    if method == "coarse":
        out = _CoarseBlock(codes_t, mesh).accumulate(data_t)
    else:
        if max_rounds is None:
            # a serpentine path can cross a block edge on every step: the
            # cell count is the only safe bound; the loop ends as soon as
            # no flow is in flight
            max_rounds = int(pshape[0] * pshape[1])
        out, stalled, last_rounds["accumulate"] = _iterate(codes_t, data_t, max_rounds, mesh)
        _check_converged(stalled, "accumulation")
    return _result(out.to(torch.float32), mesh, (nrow0, ncol0))


def tiled_rank(codes: np.ndarray, mesh: Mesh, max_rounds: int | None = None):
    """Distance to the pit (int32) over a D8 code raster sharded over
    ``mesh``: ``graph.rank`` (loops -1, missing -9999). Raises RuntimeError
    where the cross-block fixpoint reaches ``max_rounds`` (by default the
    cell count) still changing."""
    codes_t, pshape = _block(codes, mesh, 247)
    if max_rounds is None:
        max_rounds = int(pshape[0] * pshape[1])
    out, stalled, last_rounds["rank"] = _fixpoint(codes_t, None, "rank", max_rounds, mesh)
    _check_converged(stalled, "rank")
    return _result(out, mesh, codes.shape)


def tiled_basins(codes: np.ndarray, idxs_pit: np.ndarray, mesh: Mesh,
                 ids: np.ndarray | None = None, max_rounds: int | None = None):
    """Basin labels (int32) over a D8 code raster sharded over ``mesh``:
    ``basins.basins``, the pits ``idxs_pit`` seeded with the 1-based
    ``ids`` (their ordinals where None), every cell labelled with its
    outlet's id, cells that reach no seeded pit 0."""
    nrow0, ncol0 = codes.shape
    seed = np.zeros((nrow0, ncol0), dtype=np.int32)
    if ids is None:
        ids = np.arange(1, np.atleast_1d(idxs_pit).size + 1, dtype=np.int32)
    rr, cc = np.unravel_index(np.atleast_1d(idxs_pit), (nrow0, ncol0))
    seed[rr, cc] = ids
    codes_t, pshape = _block(codes, mesh, 247)
    seed_t = _block(seed, mesh, 0)[0]
    if max_rounds is None:
        max_rounds = int(pshape[0] * pshape[1])
    out, stalled, last_rounds["basins"] = _fixpoint(codes_t, seed_t, "label", max_rounds, mesh)
    _check_converged(stalled, "basins")
    return _result(out, mesh, codes.shape)


def tiled_stream_distance(codes: np.ndarray, mesh: Mesh, mask: np.ndarray | None = None,
                          real_length: bool = True, latlon: bool = False, transform=None,
                          max_rounds: int | None = None):
    """Downstream distance to the outlet (or to ``mask``) over a D8 code
    raster sharded over ``mesh``: ``streams.stream_distance``, the path
    length to the nearest pit or ``mask`` cell, in metres (float32, the
    step lengths of ``geodesy.distance_grid`` on the host; ``real_length``)
    or in cells (int32); cells that reach neither, and missing cells,
    -9999."""
    from ..codecs import d8 as d8c
    from ..utils import geodesy
    from ..utils.affine import IDENTITY

    codes = np.asarray(codes)
    nrow0, ncol0 = codes.shape
    if real_length:
        idxs_ds0 = d8c.from_array(codes)[0]
        w0 = geodesy.distance_grid(idxs_ds0, (nrow0, ncol0), latlon=latlon,
                                   transform=IDENTITY if transform is None else transform)
        w = np.asarray(w0, np.float32).reshape(nrow0, ncol0)
    else:
        w = ((d8c._DR_LUT[codes] != 0) | (d8c._DC_LUT[codes] != 0)).astype(np.float32)
    codes_t, pshape = _block(codes, mesh, 247)
    w_t = _block(w, mesh, 0.0)[0]
    cut_t = None if mask is None else _block(np.asarray(mask, bool), mesh, False)[0]
    if max_rounds is None:
        max_rounds = int(pshape[0] * pshape[1])
    out, stalled, last_rounds["stream_distance"] = _carry(codes_t, None, w_t, cut_t, "dist",
                                                          max_rounds, mesh)
    _check_converged(stalled, "stream distance")
    out = _result(out, mesh, (nrow0, ncol0))
    bad = out == _UNSET
    if real_length:
        return np.where(bad, -9999.0, out).astype(np.float32)
    return np.where(bad, -9999, np.rint(out)).astype(np.int32)


def tiled_hand(codes: np.ndarray, elevtn: np.ndarray, drain: np.ndarray, mesh: Mesh,
               nodata: float = -9999.0, max_rounds: int | None = None):
    """Height above the nearest downstream drain cell (float64), sharded over
    ``mesh``: ``elevtn`` less the float32 elevation of the first ``drain``
    cell (else the pit) on the cell's path; cells that reach neither, and
    missing cells, ``nodata``."""
    codes_t, pshape = _block(codes, mesh, 247)
    elev_t = _block(np.asarray(elevtn, np.float32), mesh, 0.0)[0]
    drain_t = _block(np.asarray(drain, bool), mesh, False)[0]
    if max_rounds is None:
        max_rounds = int(pshape[0] * pshape[1])
    zdrain, stalled, last_rounds["hand"] = _carry(codes_t, elev_t, None, drain_t, "flabel",
                                                  max_rounds, mesh)
    _check_converged(stalled, "hand")
    zdrain = _result(zdrain, mesh, codes.shape)
    hand = np.asarray(elevtn, np.float64) - zdrain
    return np.where(zdrain == _UNSET, nodata, hand)


def tiled_strahler(codes: np.ndarray, mesh: Mesh, mask: np.ndarray | None = None,
                   max_order: int = 32, max_rounds: int | None = None):
    """Strahler stream order (uint8) over a D8 code raster sharded over
    ``mesh``: ``order(c) >= s`` where c's subtree holds a cell with two
    upstream cells of order ``s - 1`` or more. Level by level: the child
    count of the member cells (on the device, ``ops.order._child_counts``,
    the JAX package's numpy stencil's count) and one coarse accumulation
    (int32; its blocks' graph made once a call). Cells outside ``mask``
    are 0 and cut the network. ``max_rounds`` is taken for the JAX
    signature: the coarse accumulation runs a fixed number of rounds."""
    from ..codecs import d8 as d8c
    from ..ops.order import _child_counts, _d8_targets

    codes = np.asarray(codes)
    nrow0, ncol0 = codes.shape
    valid = (d8c._DR_LUT[codes] != 0) | (d8c._DC_LUT[codes] != 0) | np.isin(codes, d8c._pv)
    if mask is not None:
        # orders must not propagate through cells outside the mask: cut the
        # network there
        valid = valid & np.asarray(mask, bool)
        codes = np.where(valid, codes, np.uint8(d8c._mv))
    codes_p = pad_to_tiles(codes, mesh, 247)
    member, tgt = _d8_targets(codes_p, device=mesh.device)
    codes_t = _block(codes, mesh, 247)[0]
    coarse = _CoarseBlock(codes_t, mesh)
    ty, tx = mesh.shape
    th, tw = codes_t.shape
    ti, tj = mesh.coords
    order = member.to(torch.uint8)
    last_rounds["strahler"] = 0
    for _ in range(1, max_order):
        gen = (_child_counts(member, tgt) >= 2).reshape(codes_p.shape)
        if not bool(gen.any()):
            break
        gen_t = gen[ti * th:(ti + 1) * th, tj * tw:(tj + 1) * tw].to(torch.int32)
        accu = _gather_grid(coarse.accumulate(gen_t), mesh).reshape(-1)
        member = (accu >= 1) & member
        order += member.to(torch.uint8)
        last_rounds["strahler"] += 1
    return order.reshape(codes_p.shape).cpu().numpy()[:nrow0, :ncol0]


def tiled_fill(dem: np.ndarray, mesh: Mesh, nodata=-9999.0, outlets="edge", idxs_pit=None,
               connectivity=8, max_rounds: int | None = None, max_depth: float = -1.0,
               elv_max: float | None = None):
    """Depression fill of a DEM sharded over ``mesh``: reconstruction by
    erosion (the device fill of :mod:`pyflwdir_torch.ops.fill`) with an
    8-neighbour halo a round. Each round frames the block's surface with
    its neighbours' (:meth:`Mesh.gather_halo`, +inf off the mesh), borders
    the DEM with those values, holds the frame fixed and runs a down and
    an up sweep of kernel F1 (:func:`pyflwdir_torch.kernels.fill_sweep`;
    its plain version on CPU tensors) over the (th+2, tw+2) buffer (its
    rows padded with fixed +inf to a multiple of 16 columns), to the
    global fixpoint: the host priority-flood surface. Seeds as in
    ``ops.fill.fill_setup``. ``max_depth >= 0`` caps the fill depth with
    the outer fixpoint of ``fill_depressions_dev`` (cells whose fill
    reaches it become pits and the fill reruns with them seeded).
    ``max_rounds`` (default 16 per mesh row and column, plus 64) bounds
    the sweep rounds of one fill, RuntimeError past it, and the outer
    rounds. Returns the filled DEM in ``dem``'s dtype, ``nodata`` at
    nodata cells."""
    from ..dem import get_edge

    dem = np.asarray(dem)
    nrow0, ncol0 = dem.shape
    nan = isinstance(nodata, float) and np.isnan(nodata)
    bad = np.isnan(dem) if nan else dem == nodata
    struct = np.ones((3, 3), dtype=bool)
    if connectivity == 4:
        struct[0, 0] = struct[-1, -1] = struct[0, -1] = struct[-1, 0] = False
    if idxs_pit is not None:
        seeds = np.zeros(dem.shape, bool)
        seeds.flat[np.atleast_1d(idxs_pit)] = True
    else:
        seeds = get_edge(~bad, structure=struct)
        if elv_max is not None:
            seeds = np.logical_and(seeds, dem <= elv_max)
            if not np.any(seeds):
                raise ValueError("No initial outlet cells found.")
        if outlets == "min":
            zb = np.where(seeds, dem, np.inf).astype(np.float32)
            i = np.unravel_index(np.argmin(zb), dem.shape)
            seeds = np.zeros(dem.shape, bool)
            seeds[i] = True
    if max_rounds is None:
        max_rounds = int(sum(mesh.shape) * 16 + 64)
    conn8 = connectivity == 8
    inf = float("inf")
    dem_t = _block(np.where(bad, np.inf, dem).astype(np.float32), mesh, np.inf)[0]
    bad_t = _block(bad, mesh, True)[0]
    th, tw = dem_t.shape
    # the frame's rows padded with fixed +inf columns to whole 16-byte lines
    # (F1 then loads them by bulk copies, not element by element); a fixed
    # +inf column acts as the +inf off the grid, so the sweep is the same
    wa = -(-(tw + 2) // 16) * 16
    dev = mesh.device
    # the DEM framed: its border takes the halo's values each round
    dem_pad = torch.full((th + 2, wa), inf, dtype=torch.float32, device=dev)
    dem_pad[1:-1, 1:tw + 1] = dem_t
    nodata_t = torch.tensor(nodata, dtype=torch.float32, device=dev)
    last_rounds["fill"] = last_rounds["depth"] = 0

    def fill_once(seeds_now):
        seeds_t = _block(seeds_now, mesh, False)[0]
        fix_pad = torch.ones((th + 2, wa), dtype=torch.uint8, device=dev)
        fix_pad[1:-1, 1:tw + 1] = (seeds_t | bad_t).to(torch.uint8)
        wp = torch.full((th + 2, wa), inf, dtype=torch.float32, device=dev)
        w = torch.where(seeds_t, dem_t, inf)
        rounds, changed = 0, 1
        while rounds < max_rounds and changed > 0:
            frame = mesh.gather_halo(w, inf)
            wp[:, : tw + 2] = frame
            # halo cells are fixed boundary values at the neighbours' surface
            dem_pad[0, : tw + 2], dem_pad[-1, : tw + 2] = frame[0], frame[-1]
            dem_pad[:, 0], dem_pad[:, tw + 1] = frame[:, 0], frame[:, -1]
            w1 = kernels.fill_sweep(wp, dem_pad, fix_pad, conn8, True)
            w2 = kernels.fill_sweep(w1, dem_pad, fix_pad, conn8, False)
            w_new = w2[1:-1, 1:tw + 1]
            changed = mesh.psum((w_new != w).sum())
            w = w_new
            rounds += 1
        last_rounds["fill"] += rounds
        _check_converged(changed > 0, "fill")
        return _result(torch.where(bad_t, nodata_t, w), mesh, (nrow0, ncol0))

    filled = fill_once(seeds)
    if max_depth is not None and max_depth >= 0:
        # outer fixpoint (fill_depressions_dev semantics): cells whose fill
        # reaches max_depth stay at their own elevation and become interior
        # pits; rerun with them seeded until none remain
        for _ in range(int(max_rounds)):
            deep = ~seeds & ~bad & ((filled - dem) >= max_depth)
            if not deep.any():
                break
            seeds = seeds | deep
            filled = fill_once(seeds)
            last_rounds["depth"] += 1
    return filled.astype(dem.dtype)
