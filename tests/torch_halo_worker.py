"""One rank of the halo runtime of ``tests/test_torch_halo.py``.

Spawned by that test module, ``world`` ranks at a time, each joining a gloo
process group through a ``file://`` rendezvous. It imports neither JAX nor
the test module: a spawned child imports the module of its target, and this
one costs only PyTorch and the port. Each rank runs every case of
:func:`cases` on the grids of ``inputs.npz`` and writes what it got to
``rank<r>.npz`` in ``out_dir``: a case's array, or for a call that raised,
``<case>.raised`` with the message; the test compares.
"""

import datetime
import os

import numpy as np
import torch

ACC_DATA = ("unit", "int", "rand")


def cases(p, inp):
    """The calls of one rank, by case name, on the module ``p``
    (``pyflwdir_torch.parallel`` or ``pyflwdir_tpu.parallel``) and its
    ``mesh`` argument: ``{name: (function, args, kwargs)}``."""
    small, large, serp = inp["small"], inp["large"], inp["serp"]
    out = {"acc.small.coarse.unit": (p.tiled_accumulate, (small, inp["small.unit"]), {})}
    for method in ("coarse", "iterate"):
        for d in ACC_DATA:
            out[f"acc.large.{method}.{d}"] = (p.tiled_accumulate, (large, inp[f"large.{d}"]),
                                              dict(method=method))
    for g in ("small", "large", "serp"):
        out[f"rank.{g}"] = (p.tiled_rank, (inp[g],), {})
    out["rank.serp.guard"] = (p.tiled_rank, (serp,), dict(max_rounds=2))
    out["acc.serp.iterate.guard"] = (p.tiled_accumulate, (serp, inp["serp.unit"]),
                                     dict(method="iterate", max_rounds=2))
    out["basins.small"] = (p.tiled_basins, (small, inp["small.pits"]), {})
    out["basins.large.ids"] = (p.tiled_basins, (large, inp["large.pits_some"]),
                               dict(ids=inp["large.ids_some"]))
    out["sd.cells"] = (p.tiled_stream_distance, (large,), dict(real_length=False))
    out["sd.m"] = (p.tiled_stream_distance, (large,), {})
    out["sd.mask"] = (p.tiled_stream_distance, (large,), dict(mask=inp["large.mask"],
                                                              real_length=False))
    out["hand"] = (p.tiled_hand, (large, inp["large.elev"], inp["large.drain"]), {})
    out["strahler"] = (p.tiled_strahler, (large,), {})
    out["strahler.mask"] = (p.tiled_strahler, (large,), dict(mask=inp["large.smask"]))
    out["fill"] = (p.tiled_fill, (inp["dem"],), dict(nodata=-9999.0))
    out["fill.depth"] = (p.tiled_fill, (inp["dem2"],), dict(max_depth=0.3))
    out["fill.elv_max"] = (p.tiled_fill, (inp["dem2"],), dict(elv_max=1.5))
    out["fill.conn4"] = (p.tiled_fill, (inp["dem"],), dict(connectivity=4))
    out["fill.min"] = (p.tiled_fill, (inp["dem2"],), dict(outlets="min"))
    out["fill.pits"] = (p.tiled_fill, (inp["dem2"],), dict(idxs_pit=inp["dem2.pits"]))
    return out


def run(rank, world, rdv, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from pyflwdir_torch import parallel
    from pyflwdir_torch.parallel import tiled

    timeout = datetime.timedelta(seconds=60)
    if world == 1:  # init_distributed starts no group for one process
        dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=1, rank=0,
                                timeout=timeout)
    else:
        assert parallel.init_distributed(f"file://{rdv}", world, rank, device="cpu",
                                         timeout=timeout)
    mesh = parallel.make_mesh(device="cpu")
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    res = {"mesh_shape": np.array(mesh.shape)}
    for name, (fn, args, kw) in cases(parallel, inp).items():
        try:
            res[name] = np.asarray(fn(*args, mesh, **kw))
        except RuntimeError as e:
            res[name + ".raised"] = np.array(str(e))
        if name == "fill.depth":
            res["fill.depth.rounds"] = np.array(tiled.last_rounds["depth"])
    res["rounds.strahler"] = np.array(tiled.last_rounds["strahler"])
    # a block with more exit cells than slots: every rank raises
    slots = tiled._exit_slots
    tiled._exit_slots = lambda th, tw: 2
    try:
        parallel.tiled_accumulate(inp["large"], inp["large.unit"], mesh)
    except RuntimeError as e:
        res["overflow.raised"] = np.array(str(e))
    tiled._exit_slots = slots
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
