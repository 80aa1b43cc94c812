"""Multi-process set-up: ``torch.distributed`` start-up and the global mesh.

* :func:`init_distributed` — an idempotent ``init_process_group`` from its
  arguments or the standard ``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``WORLD_SIZE`` / ``RANK`` variables (as the JAX package reads its
  ``JAX_*`` ones); it does nothing for a single process, so library code
  may call it unconditionally. NCCL joins CUDA ranks, gloo CPU ones, with a
  finite timeout: a broken rendezvous fails instead of hanging.
* :func:`global_mesh` — a 2-D ("ty", "tx") mesh over every rank, host-major:
  the ranks of one host stay contiguous along the fast "tx" axis.

The JAX package's scaling model and reports carry the TPU's rates and wait
for a later slice (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .tiled import Mesh, _grid_shape, _rank_device, make_mesh

__all__ = ["init_distributed", "global_mesh"]

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
