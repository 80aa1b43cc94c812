"""Multi-process set-up: ``torch.distributed`` start-up and the global mesh.

* :func:`init_distributed` — an idempotent ``init_process_group`` from its
  arguments or the standard ``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``WORLD_SIZE`` / ``RANK`` variables (as the JAX package reads its
  ``JAX_*`` ones); it does nothing for a single process, so library code
  may call it unconditionally. NCCL joins CUDA ranks, gloo CPU ones, with a
  finite timeout: a broken rendezvous fails instead of hanging.
* :func:`global_mesh` — a 2-D ("ty", "tx") mesh over every rank, host-major:
  the ranks of one host stay contiguous along the fast "tx" axis;
* :func:`scaling_model` — a static account of one sharded tile-plan sweep
  (bytes a rank streams against bytes it gathers) at the H100's rates;
* :func:`scaling_report` / :func:`weak_scaling_report` — strong- and
  weak-scaling walls of ``tiled_accumulate`` on meshes of the current
  group's first k ranks.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .tiled import Mesh, _grid_shape, _rank_device, make_mesh, tiled_accumulate

__all__ = ["init_distributed", "global_mesh", "scaling_report", "scaling_model",
           "weak_scaling_report"]

# NVIDIA H100 SXM5 (80 GB) data sheet: HBM3 at 3.35 TB/s; NVLink 4 at
# 900 GB/s a GPU, both directions together, so 450 GB/s inbound
H100_HBM_GBPS = 3350.0
H100_NVLINK_GBPS = 450.0

# the per-tile tables one upward sharded sweep reads (int16 on the card)
_UP_TABLES = ("rin", "ex_end", "ent_idx", "near_end", "far_end", "rout")

#: how long a rank waits for the others at start-up and in a collective
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     device=None, timeout=DEFAULT_TIMEOUT):
    """Start the default process group from the arguments or the
    environment; safe to call twice. Returns True where a group runs.

    ``coordinator_address``: ``host:port`` (TCP) or a URL such as
    ``file:///path``; ``MASTER_ADDR`` and ``MASTER_PORT`` (default 29500)
    where None. ``num_processes`` and ``process_id`` default to
    ``WORLD_SIZE`` and ``RANK``. Nothing happens for one process or none.
    ``device``: ``"cpu"`` joins the ranks with gloo; else NCCL, each rank on
    the card of its local rank (``LOCAL_RANK``, or the rank modulo the
    cards), which it makes current; with no GPU that raises."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "0")) or None
    if process_id is None and os.environ.get("RANK") is not None:
        process_id = int(os.environ["RANK"])
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("init_distributed: the process id (RANK) is missing")
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(_rank_device(device, process_id))
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init,
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timeout)
    return True


def global_mesh(device=None) -> Mesh:
    """2-D ("ty", "tx") mesh over every rank, host-major: with
    ``LOCAL_WORLD_SIZE`` ranks on each of several hosts, one row per host;
    else as square as the count allows (:func:`make_mesh`)."""
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", "0")) or world
    n_hosts = world // per_host
    hosts = n_hosts > 1 and n_hosts * per_host == world
    shape = (n_hosts, per_host) if hosts else _grid_shape(world)
    return Mesh(dist.group.WORLD, rank, world, shape, _rank_device(device, rank))


def scaling_model(tp, n_devices, hbm_gbps=H100_HBM_GBPS, ici_gbps=H100_NVLINK_GBPS,
                  overlap_chunks=2, cells_scale=1.0):
    """Static communication / computation model of one sharded tile-plan
    sweep (:meth:`TilePlan.accumulate_sharded`), from the plan alone: the
    JAX package's formula fed the port's plan. Per rank and sweep: the
    bytes kernels T1 and T2 stream over its slab (``compute_bytes``: the
    upward per-tile tables as the card holds them, int16, plus the data
    read and the result and prefix sums written, 4 bytes each a cell) at
    ``hbm_gbps``, and ONE gather of the per-tile exit records (int32;
    ``collective_bytes`` = (n - 1) / n of them) at ``ici_gbps``, the
    inbound NVLink rate. The defaults are the NVIDIA H100 SXM5's data-sheet
    rates (HBM3 3.35 TB/s; NVLink 4 900 GB/s both ways). Predicted
    efficiency = t_compute / (t_compute + t_comm), with the gather hidden
    under pass A's chunks (``predicted_efficiency_overlap``) and carrying
    only the exits of the slabs' perimeter tiles
    (``predicted_efficiency_hierarchical``) besides. ``cells_scale``
    projects the plan's per-cell account to a grid that many times larger
    of the same drainage statistics."""
    tab = sum(np.asarray(tp.idx[k]).size * 2 for k in _UP_TABLES)
    H, W = tp.pshape
    n_cells = H * W * cells_scale
    bpc = tab / (H * W) + 3 * 4
    compute_bytes = bpc * n_cells / n_devices
    exits_bytes = tp.n_exit_flat * 4 * cells_scale
    collective_bytes = exits_bytes * (n_devices - 1) / max(n_devices, 1)
    t_compute = compute_bytes / (hbm_gbps * 1e9)
    t_comm = collective_bytes / (ici_gbps * 1e9)
    # pass A runs in chunks and each chunk's exit gather hides under the
    # remaining chunks' compute: the two-stage pipeline bound
    C = max(int(overlap_chunks), 1)
    ta = t_compute / 3  # pass A's share of the sweep's bytes
    t_ov = t_compute + t_comm - min(t_comm, ta) * (1 - 1 / C)
    # only block-crossing flows need the gather when each rank contracts
    # its own coarse forest first: the exits of a ~square slab's perimeter
    # tiles
    gscale = max(int(round(np.sqrt(cells_scale))), 1)
    nty, ntx = tp.grid[0] * gscale, tp.grid[1] * gscale
    per_dev = max(nty * ntx // n_devices, 1)
    a = max(int(np.sqrt(per_dev * nty / max(ntx, 1))), 1)
    b = max(per_dev // a, 1)
    interior = max(a - 2, 0) * max(b - 2, 0)
    perim_frac = 1.0 - interior / (a * b)
    hier_bytes = exits_bytes * perim_frac * (n_devices - 1) / n_devices
    t_comm_h = hier_bytes / (ici_gbps * 1e9)
    t_h = t_compute + t_comm_h - min(t_comm_h, ta) * (1 - 1 / C)
    return {
        "n_devices": n_devices,
        "bytes_per_cell": bpc,
        "compute_bytes_per_device": compute_bytes,
        "collective_bytes_per_device": collective_bytes,
        "collectives_per_sweep": 1,
        "t_compute_model_s": t_compute,
        "t_comm_model_s": t_comm,
        "predicted_efficiency": t_compute / (t_compute + t_comm),
        "predicted_efficiency_overlap": t_compute / t_ov,
        "predicted_efficiency_hierarchical": t_compute / t_h,
        "hierarchical_collective_bytes": hier_bytes,
        "overlap_chunks": C,
        "assumptions": {
            "device": "NVIDIA H100 SXM5 80GB (data sheet rates)",
            "hbm_gbps_per_chip": hbm_gbps,
            "ici_gbps_per_link": ici_gbps,
            "tables": "int16 per-tile tables " + ", ".join(_UP_TABLES),
            "overlap": (
                "per-chunk exit gathers hide under the remaining pass-A chunks "
                "(accumulate_sharded overlap_chunks); the no-overlap column is the "
                "lower bound"
            ),
            "hierarchical": (
                "the gather carries only block-crossing exits (perimeter tiles of "
                "~square slabs) after each rank contracts its own coarse forest; "
                "TilePlan.accumulate_sharded ships the full gather"
            ),
        },
    }


def _world():
    started = dist.is_available() and dist.is_initialized()
    return dist.get_world_size() if started else 1


def _best_wall(codes, data, mesh, reps):
    """The best of ``reps`` walls of ``tiled_accumulate`` after one warm-up
    call, the slowest rank's (its result comes back to the host, so the
    wall covers the device work)."""
    tiled_accumulate(codes, data, mesh)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        tiled_accumulate(codes, data, mesh)
        best = min(best, time.perf_counter() - t0)
    t = torch.tensor([best], dtype=torch.float64, device=mesh.device)
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.item()


def _from_rank0(value, device):
    """Rank 0's float ``value`` on every rank of the world."""
    if _world() == 1:
        return value
    t = torch.tensor([0.0 if value is None else value], dtype=torch.float64,
                     device=_rank_device(device, dist.get_rank()))
    dist.broadcast(t, 0)
    return t.item()


def weak_scaling_report(cells_per_device=256 * 256, n_devices_list=None, reps=2,
                        device=None):
    """Weak scaling of ``tiled_accumulate``: the work per rank held while the
    grid grows with the mesh, on the first k ranks of the current group for
    each k of ``n_devices_list`` (1, 2 and the world by default; every
    rank must call, ranks outside a mesh wait). Returns ``{k: {"grid",
    "cells_per_device", "t_s", "cells_per_s_per_device"}}`` on the ranks of
    each mesh. ``device``: as :func:`make_mesh`."""
    from .. import dem as dem_mod

    world = _world()
    if n_devices_list is None:
        n_devices_list = sorted({1, 2, world} & set(range(1, world + 1)))
    out = {}
    for k in n_devices_list:
        mesh = make_mesh(k, device=device)
        ty, tx = _grid_shape(k)
        rows = int(np.sqrt(cells_per_device * k / (ty * tx))) * ty
        cols = int(cells_per_device * k / max(rows, 1)) // 128 * 128 or 128
        rng = np.random.RandomState(3)
        z = rng.rand(max(rows, 128), max(cols, 128))
        z += np.add.outer(np.linspace(2, 0, z.shape[0]), np.linspace(2, 0, z.shape[1]))
        codes = dem_mod.fill_depressions(z)[1]
        if mesh is not None:
            t = _best_wall(codes, np.ones(codes.shape, dtype=np.float32), mesh, reps)
            out[k] = {"grid": list(codes.shape), "cells_per_device": codes.size / k,
                      "t_s": t, "cells_per_s_per_device": codes.size / k / t}
        if world > 1:
            dist.barrier()
    return out


def scaling_report(codes: np.ndarray, n_devices_list=None, reps=3, device=None):
    """Strong scaling of ``tiled_accumulate`` on the fixed grid ``codes``,
    on the first k ranks of the current group for each k of
    ``n_devices_list`` (1, 2, 4 and the world, as many as it has, by
    default; every rank must call, ranks outside a mesh wait). Returns
    ``{k: {"t_s", "speedup", "efficiency"}}``, efficiency = speedup / k
    against the one-rank wall, on the ranks of each mesh (the one-rank
    entries on rank 0 alone). ``device``: as :func:`make_mesh`."""
    world = _world()
    if n_devices_list is None:
        n_devices_list = sorted({k for k in (1, 2, 4, world) if k <= world})
    data = np.ones(codes.shape, dtype=np.float32)
    out, t1 = {}, None
    for k in n_devices_list:
        mesh = make_mesh(k, device=device)
        if mesh is not None:
            t = _best_wall(codes, data, mesh, reps)
        if t1 is None:  # the first mesh's wall is the yardstick
            t1 = _from_rank0(t if mesh is not None else None, device)
        if mesh is not None:
            out[k] = {"t_s": t, "speedup": t1 / t, "efficiency": t1 / t / k}
        if world > 1:
            dist.barrier()
    return out
