"""Entry points: the flagship pipeline on the card, and a multi-rank dry run.

``entry()`` returns the flagship step and its arguments: flow accumulation
through the hierarchical tile plan (:mod:`pyflwdir_torch.ops.tile_plan`,
the path ``FlwdirRaster.upstream_area`` takes above 2^21 cells), then
``graph.roots`` and ``graph.rank``, all on the device.

``dryrun_multichip(n)`` runs the sharded runtime (:mod:`pyflwdir_torch.
parallel`) on a mesh of the first n ranks of the current process group
(one process without a group for n = 1), validates each function against
the one-device functions on small shapes, and writes a report of the
scaling model and of strong- and weak-scaling walls where asked.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ._backend import resolve_device

__all__ = ["entry", "dryrun_multichip"]

#: environment variable naming a D8 GeoTIFF (the Rhine's) for :func:`entry`
RHINE_D8_ENV = "PYFLWDIR_RHINE_D8"


def _demo_grid(shape=(64, 96), seed=7):
    """A small D8 grid from a seeded DEM, filled on the host."""
    from . import dem

    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    return dem.fill_depressions(z)[1]


def _rhine_codes():
    """The D8 raster the :data:`RHINE_D8_ENV` variable names, or None where
    it is unset or cannot be read."""
    path = os.environ.get(RHINE_D8_ENV)
    if not path:
        return None
    try:
        from PIL import Image

        return np.array(Image.open(path))
    except (ImportError, OSError):
        return None


def entry(device=None):
    """``(pipeline, args)``: ``pipeline(*args)`` returns ``(uparea, roots,
    rank)`` of the Rhine raster (where :data:`RHINE_D8_ENV` names it, else a
    seeded 256 x 384 demo grid) as (H, W) tensors on ``device`` (the card
    where None): the tile plan's accumulation of unit weights (float32),
    then ``graph.roots`` and ``graph.rank``. The plan is built on the host
    first, as the reference caches its topological order."""
    from .codecs import d8 as d8c
    from .ops import graph
    from .ops.tile_plan import build_tile_plan

    dev = resolve_device(device)
    codes = _rhine_codes()
    if codes is None:
        codes = _demo_grid((256, 384))
    idxs_ds_np = d8c.from_array(codes, dtype=np.int64)[0]
    tp = build_tile_plan(idxs_ds_np, codes.shape, device=dev)
    shape = codes.shape

    def pipeline(idxs_ds, data):
        """(uparea, basin roots, rank), all on the device."""
        return (tp.accumulate(data).reshape(shape), graph.roots(idxs_ds).reshape(shape),
                graph.rank(idxs_ds).reshape(shape))

    args = (torch.as_tensor(idxs_ds_np, device=dev),
            torch.ones(idxs_ds_np.size, dtype=torch.float32, device=dev))
    return pipeline, args


def dryrun_multichip(n_devices: int, report_path=None, device=None):
    """Run the sharded runtime on ``make_mesh(n_devices)`` of the current
    process group (every rank of it must call) on small shapes, each
    function validated against the one-device functions: tiled_fill against
    the host flood, tiled_accumulate (coarse, iterate, plan; mass
    conservation), the sharded downward sweep, tiled_rank, tiled_basins,
    tiled_stream_distance and tiled_hand. Then the scaling model of a
    1024 x 1024 plan at the H100's rates and the strong- and weak-scaling
    walls of ``tiled_accumulate``. Writes the report (JSON) to
    ``report_path`` where given, and returns it. ``device``: as
    :func:`pyflwdir_torch.parallel.make_mesh` (the card where None)."""
    from . import basins as basins_mod
    from . import dem as dem_mod
    from . import streams as streams_mod
    from .codecs import d8 as d8c
    from .ops import graph
    from .ops.tile_plan import build_tile_plan
    from .parallel import (build_sharded_plan, init_distributed, make_mesh, tiled_accumulate,
                           tiled_basins, tiled_fill, tiled_hand, tiled_rank,
                           tiled_stream_distance)
    from .parallel.distributed import scaling_model, scaling_report, weak_scaling_report

    init_distributed(device=device)  # nothing to do for one process
    mesh = make_mesh(n_devices, device=device)
    sizes = sorted({1, n_devices})
    if mesh is None:  # a rank outside the mesh: only the reports' collectives
        strong = scaling_report(_demo_grid((16, 16)), n_devices_list=sizes, reps=1, device=device)
        weak_scaling_report(n_devices_list=sizes, reps=1, device=device)
        return strong
    dev = mesh.device
    ty, tx = mesh.shape

    # a DEM with a depression across block edges: the tiled fill against the host's
    rng = np.random.RandomState(7)
    z = rng.rand(8 * ty, 8 * tx)
    z += np.add.outer(np.linspace(2, 0, 8 * ty), np.linspace(2, 0, 8 * tx))
    z[2:5, 3:6] -= 1.0
    filled_host, codes = dem_mod.fill_depressions(z)
    if not np.allclose(tiled_fill(z, mesh), filled_host):
        raise AssertionError("tiled fill != host fill")

    idxs_ds, idxs_pit, n_valid = d8c.from_array(codes, dtype=np.int64)
    ids_t = torch.as_tensor(idxs_ds, device=dev)
    valid = (idxs_ds >= 0).reshape(codes.shape)
    data = np.ones(codes.shape, dtype=np.float32)
    out = tiled_accumulate(codes, data, mesh)
    if abs(float(out.ravel()[idxs_pit].sum()) - n_valid) > 1e-3:
        raise AssertionError("tiled accumulation does not conserve mass")
    for method in ("iterate", "plan"):
        if not np.array_equal(tiled_accumulate(codes, data, mesh, method=method), out):
            raise AssertionError(f"tiled_accumulate(method={method!r}) != coarse")

    # the sharded downward sweep against the one-device one
    tp2, pshape = build_sharded_plan(codes, mesh)
    ids_p = d8c.from_array(np.pad(codes, ((0, pshape[0] - codes.shape[0]),
                                          (0, pshape[1] - codes.shape[1])),
                                  constant_values=np.uint8(247)), dtype=np.int64)[0]
    wdn = torch.as_tensor((ids_p >= 0).astype(np.int32), device=dev)
    if not torch.equal(tp2.accumulate_down(wdn), tp2.accumulate_down_sharded(wdn, mesh)):
        raise AssertionError("sharded downward sweep mismatch")

    if not np.array_equal(tiled_rank(codes, mesh),
                          graph.rank(ids_t).cpu().numpy().reshape(codes.shape)):
        raise AssertionError("tiled rank mismatch")
    want = basins_mod.basins(ids_t, idxs_pit).reshape(codes.shape)
    if not np.array_equal(tiled_basins(codes, idxs_pit, mesh), want):
        raise AssertionError("tiled basins mismatch")
    dist_ = tiled_stream_distance(codes, mesh, real_length=False)
    want = streams_mod.stream_distance(ids_t, codes.shape, real_length=False)
    if not np.array_equal(dist_[valid], np.asarray(want.cpu()).reshape(codes.shape)[valid]):
        raise AssertionError("tiled stream distance mismatch")
    drain = np.zeros(codes.shape, bool)
    drain[::3, ::3] = True
    drain &= valid
    elev = filled_host.astype(np.float32)
    hand = tiled_hand(codes, elev, drain, mesh)
    want = dem_mod.height_above_nearest_drain(ids_t, torch.as_tensor(drain.ravel(), device=dev),
                                              torch.as_tensor(elev.ravel(), device=dev))
    if not np.allclose(hand[valid], want.cpu().numpy().reshape(codes.shape)[valid], atol=1e-5):
        raise AssertionError("tiled hand mismatch")

    # the scaling model of a 1024 x 1024 plan, and the walls
    side = 1024
    zz = np.random.RandomState(11).rand(side, side)
    zz += np.add.outer(np.linspace(4, 0, side), np.linspace(4, 0, side))
    ids_big = d8c.from_array(dem_mod.fill_depressions(zz)[1], dtype=np.int64)[0]
    tp = build_tile_plan(ids_big, (side, side), device=dev)
    strong = scaling_report(codes, n_devices_list=sizes, reps=1, device=device)
    weak = weak_scaling_report(n_devices_list=sizes, reps=1, device=device)
    report = {
        "device": {"type": dev.type, "name": (torch.cuda.get_device_name(dev)
                                              if dev.type == "cuda" else "cpu"),
                   "ranks": mesh.size, "mesh": list(mesh.shape)},
        "validated": True,
        "note": ("comm_model is a static account of TilePlan.accumulate_sharded (one gather "
                 "of exit records a sweep) from the plan and the H100 data-sheet rates; the "
                 "scaling walls are this run's, on the device above"),
        "comm_model": {str(k): scaling_model(tp, k) for k in (2, 4, 8)},
        "comm_model_grid": [side, side],
        "comm_model_67M": {str(k): scaling_model(tp, k, cells_scale=64.0) for k in (8, 16, 64)},
        "strong_scaling": {str(k): v for k, v in strong.items()},
        "weak_scaling": {str(k): v for k, v in weak.items()},
    }
    if report_path is not None and mesh.rank == 0:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1, default=float)
    return report
