"""Multi-device runtime on ``torch.distributed``: the mesh and the sharded
tile plan.

A :class:`Mesh` is the ranks of a process group (one device each) laid out
as a 2-D ("ty", "tx") grid, as the JAX package's ``make_mesh`` lays out its
devices. :func:`tiled_accumulate` with ``method="plan"`` shards a
hierarchical :class:`~pyflwdir_torch.ops.tile_plan.TilePlan` over it
(:meth:`TilePlan.accumulate_sharded`): every rank runs kernels T1 and T2 on
its contiguous slab of tiles, with one gather of the per-tile exit records
between them. NCCL joins ranks on CUDA, gloo on the CPU
(:func:`pyflwdir_torch.parallel.init_distributed`).

The JAX package's halo runtime (``method="coarse"`` and ``"iterate"``,
:func:`tiled_rank`, :func:`tiled_basins`, :func:`tiled_fill`,
:func:`tiled_stream_distance`, :func:`tiled_hand`, :func:`tiled_strahler`)
is not ported yet: those raise NotImplementedError.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from .._backend import resolve_device

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
]

_HALO_LATER = ("the halo runtime (send/recv between neighbouring ranks) is queued for a "
               "later slice of the PyTorch port (ROADMAP Queue 1 item 5)")


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

    def __repr__(self):
        return f"Mesh(rank={self.rank}, size={self.size}, shape={self.shape}, device={self.device})"

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
    """Build a :class:`~pyflwdir_torch.ops.tile_plan.TilePlan` on the rank's
    device whose tile grid splits evenly over ``mesh``: the D8 ``codes``
    padded with nodata to whole tile-row slabs per rank (rows to a multiple
    of ``tile_rows * size``, columns to 128), as the JAX package pads them,
    so the two build the same graph. Returns ``(plan, pshape)``, ``pshape``
    the padded shape the plan runs on."""
    from ..codecs import d8 as d8c
    from ..ops.tile_plan import build_tile_plan

    if tile_rows != 128:
        raise NotImplementedError(
            f"tile plans of {tile_rows} rows: the port's tiles are 128 rows high; taller "
            "tiles are queued for a later slice (ROADMAP Queue 1 item 2)")
    pr = (-codes.shape[0]) % (tile_rows * mesh.size)
    pc = (-codes.shape[1]) % 128
    codes_p = np.pad(np.asarray(codes), ((0, pr), (0, pc)), constant_values=247)
    idxs_ds = d8c.from_array(codes_p)[0]
    return build_tile_plan(idxs_ds, codes_p.shape, device=mesh.device), codes_p.shape


def tiled_accumulate(codes: np.ndarray, data: np.ndarray, mesh: Mesh,
                     max_rounds: int | None = None, method: str = "coarse"):
    """Flow accumulation of ``data`` over a D8 code raster, sharded over
    ``mesh``; returns the dense float32 grid of the input's shape.

    ``method="plan"`` shards a tile plan over the mesh
    (:func:`build_sharded_plan`, :meth:`TilePlan.accumulate_sharded`): the
    data go in as float32, sum in float64 and come back as float32. The
    JAX package's other methods (``"coarse"``, its default, and
    ``"iterate"``) run on its halo runtime, not ported yet: they raise
    NotImplementedError."""
    if method in ("coarse", "iterate"):
        raise NotImplementedError(f'tiled_accumulate(method="{method}"): {_HALO_LATER}')
    if method != "plan":
        raise ValueError(f'unknown method "{method}"')
    nrow0, ncol0 = codes.shape
    tp, pshape = build_sharded_plan(codes, mesh)
    data_p = np.zeros(pshape, dtype=np.float32)
    data_p[:nrow0, :ncol0] = np.asarray(data, dtype=np.float32)
    out = tp.accumulate_sharded(torch.as_tensor(data_p.ravel(), device=mesh.device), mesh)
    return out.cpu().numpy().reshape(pshape)[:nrow0, :ncol0]


def tiled_rank(codes, mesh, max_rounds=None):
    """Distance to the pit, sharded: not ported yet (raises)."""
    raise NotImplementedError(f"tiled_rank: {_HALO_LATER}")


def tiled_basins(codes, idxs_pit, mesh, ids=None, max_rounds=None):
    """Basin labels, sharded: not ported yet (raises)."""
    raise NotImplementedError(f"tiled_basins: {_HALO_LATER}")


def tiled_stream_distance(codes, mesh, mask=None, real_length=True, latlon=False,
                          transform=None, max_rounds=None):
    """Distance to the outlet, sharded: not ported yet (raises)."""
    raise NotImplementedError(f"tiled_stream_distance: {_HALO_LATER}")


def tiled_hand(codes, elevtn, drain, mesh, nodata=-9999.0, max_rounds=None):
    """Height above the nearest drain, sharded: not ported yet (raises)."""
    raise NotImplementedError(f"tiled_hand: {_HALO_LATER}")


def tiled_strahler(codes, mesh, mask=None, max_order=32, max_rounds=None):
    """Strahler order, sharded: not ported yet (raises)."""
    raise NotImplementedError(f"tiled_strahler: {_HALO_LATER}")


def tiled_fill(dem, mesh, nodata=-9999.0, outlets="edge", idxs_pit=None, connectivity=8,
               max_rounds=None, max_depth=-1.0, elv_max=None):
    """Depression fill, sharded: not ported yet (raises)."""
    raise NotImplementedError(f"tiled_fill: {_HALO_LATER}")
