"""One rank of the sharded tile-plan sweeps of ``tests/test_torch_sharded.py``.

Spawned by that test module, ``world`` ranks at a time, each joining a gloo
process group through a ``file://`` rendezvous. It imports neither JAX nor
the test module: a spawned child imports the module of its target, and this
one costs only PyTorch and the port. Each rank builds the tile plans of the
grids in ``inputs.npz`` on the CPU, runs every case and writes what it got
to ``rank<r>.npz`` in ``out_dir``; the test compares.
"""

import datetime
import os

import numpy as np
import torch

# the cases each rank runs
DTYPES = ("int32", "int64", "float64")
CHUNKS = (1, 2, 3)


def tall_plans(inp, mesh):
    """The plans of 256-row tiles of the "entries" grid: built on the grid
    ("direct") and by ``parallel.build_sharded_plan`` for ``mesh``
    ("padded"; only its size and device are read)."""
    from pyflwdir_torch import parallel
    from pyflwdir_torch.ops.tile_plan import build_tile_plan

    shape = tuple(inp["entries.shape"])
    return {"direct": build_tile_plan(inp["entries.ids"], shape, tile_rows=256, device="cpu"),
            "padded": parallel.build_sharded_plan(inp["entries.codes"], mesh, tile_rows=256)[0]}


def tall_data(x, shape, pshape):
    """The grid's data ``x`` zero padded to the plan's shape."""
    out = np.zeros(tuple(pshape), x.dtype)
    out[: shape[0], : shape[1]] = x.reshape(tuple(shape))
    return out.ravel()


def run(rank, world, rdv, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from pyflwdir_torch import parallel
    from pyflwdir_torch.ops.tile_plan import build_tile_plan

    if world == 1:  # init_distributed starts no group for one process
        dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=60))
    else:
        assert parallel.init_distributed(f"file://{rdv}", world, rank, device="cpu")
    mesh = parallel.make_mesh(device="cpu")
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    res = {}
    for grid in ("entries", "closed"):
        shape = tuple(inp[f"{grid}.shape"])
        tp = build_tile_plan(inp[f"{grid}.ids"], shape, device="cpu")
        for dt in DTYPES:
            x = torch.as_tensor(inp[f"data.{dt}"])
            for c in CHUNKS:
                up = tp.accumulate_sharded(x, mesh, overlap_chunks=c)
                res[f"up.{grid}.{dt}.{c}"] = up.numpy()
            res[f"down.{grid}.{dt}"] = tp.accumulate_down_sharded(x, mesh).numpy()
    res["plan"] = parallel.tiled_accumulate(inp["entries.codes"], inp["data.float32"], mesh,
                                            method="plan")
    # tiles of 256 rows (thread-block clusters of two CTAs on the card): a
    # plan of the grid (NT 8: on 4 ranks a slab is half a tile row) and the
    # sharded plan, padded to whole tile-row slabs
    for kind, tp in tall_plans(inp, mesh).items():
        for dt in DTYPES:
            x = torch.as_tensor(tall_data(inp[f"data.{dt}"], inp["entries.shape"], tp.shape))
            res[f"tall.{kind}.up.{dt}"] = tp.accumulate_sharded(x, mesh).numpy()
            res[f"tall.{kind}.down.{dt}"] = tp.accumulate_down_sharded(x, mesh).numpy()
    # a plan of 2 x 3 tiles does not split over 4 ranks
    odd = build_tile_plan(inp["odd.ids"], tuple(inp["odd.shape"]), device="cpu")
    try:
        odd.accumulate_sharded(torch.zeros(odd.shape[0] * odd.shape[1]), mesh)
        res["odd_raised"] = np.array(False)
    except ValueError:
        res["odd_raised"] = np.array(True)
    res["mesh_shape"] = np.array(mesh.shape)
    for n in range(1, world + 1):  # a subgroup of the first n ranks
        sub = parallel.make_mesh(n, device="cpu")
        res[f"mesh_shape.{n}"] = np.array(sub.shape if sub is not None else (0, 0))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
