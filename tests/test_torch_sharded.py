"""The sharded tile-plan sweeps of the port against the JAX package's, on the
CPU: ``TilePlan.accumulate_sharded`` and ``accumulate_down_sharded`` over 1,
2 and 4 gloo ranks, spawned as processes (``tests/torch_sharded_worker.py``),
with the kernels' plain versions.

Grids: a seeded 384 x 512 D8 raster (3 x 4 tiles, NT 12: two and four
ranks cut a tile row in the middle; entry cells, a gather coarse level) and
one of closed tiles (each tile drains to pits of its own: no entry cells,
so the downward sweep is pass D1 alone). Upward with ``overlap_chunks`` 1, 2
and 3 (the chunk count drops until it divides the slab). int32 and int64
results are bitwise equal to the JAX package's sharded sweeps on its
2-device virtual mesh (integer data; its sums run in int64) and to its
single-device ones; every dtype is bitwise equal to the port's unsharded
sweep, on every rank; float64 stays within rtol 1e-12 plus 2 * L * eps *
total of the JAX sweep (L the additions on the longest chain summed in
another order: a tile's 16,384 slots and the coarse level's, twice).
Plans of 256-row tiles, built on the grid and by ``build_sharded_plan``,
run sharded on every world too: bitwise their unsharded sweeps, integers
bitwise the JAX plan of 256-row tiles.
"""

import multiprocessing
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyflwdir_torch import dem as tdem
from pyflwdir_torch import parallel, runtime
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu.ops import tile_plan as jtpm
from pyflwdir_tpu.parallel import make_mesh as jmake_mesh
from tests import torch_sharded_worker as worker

_EPS = np.finfo(np.float64).eps
WORLDS = (1, 2, 4)
JOIN_S = 240  # the most a spawned world may take; it is killed past that


def _demo_d8(shape, seed):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape) + np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    d8 = tdem.fill_depressions(z)[1]
    d8[1, 2:5] = 247  # missing cells
    return d8


def _closed_tiles(shape):
    """Every cell flows east to a pit in the last column of its tile."""
    d8 = np.ones(shape, np.uint8)
    d8[:, 127::128] = 0
    d8[5, 3:6] = 247
    return d8


def _spawn(worlds, out_dirs):
    """Start every world's ranks at once; returns the processes."""
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world, out_dir in zip(worlds, out_dirs):
        rdv = os.path.join(out_dir, "rendezvous")
        for rank in range(world):
            p = ctx.Process(target=worker.run, args=(rank, world, rdv, out_dir), daemon=True)
            p.start()
            procs.append((world, rank, p))
    return procs


def _join(procs):
    """Wait for every rank, killing all of them past ``JOIN_S`` seconds."""
    import time

    deadline = time.monotonic() + JOIN_S
    for world, rank, p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [(w, r) for w, r, p in procs if p.is_alive()]
    for _, _, p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not late, f"ranks (world, rank) {late} did not finish in {JOIN_S} s"
    bad = [(w, r, p.exitcode) for w, r, p in procs if p.exitcode != 0]
    assert not bad, f"ranks (world, rank, exit code) failed: {bad}"


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The inputs, the spawned ranks' results, and the references."""
    codes = _demo_d8((384, 512), 11)
    grids = {"entries": codes, "closed": _closed_tiles((384, 512)),
             "odd": _demo_d8((256, 384), 12)}
    ids = {k: td8.from_array(v, dtype=np.int64)[0] for k, v in grids.items()}
    n = codes.size
    rng = np.random.RandomState(5)
    w = rng.randint(0, 5, n)
    data = {"int32": w.astype(np.int32), "int64": w.astype(np.int64),
            "float64": rng.rand(n), "float32": rng.rand(*codes.shape).astype(np.float32)}
    inputs = {f"{k}.ids": v for k, v in ids.items()}
    inputs.update({f"{k}.shape": np.array(v.shape) for k, v in grids.items()})
    inputs["entries.codes"] = codes
    inputs.update({f"data.{k}": v for k, v in data.items()})
    out_dirs = [str(tmp_path_factory.mktemp(f"world{w}")) for w in WORLDS]
    for d in out_dirs:
        np.savez(os.path.join(d, "inputs.npz"), **inputs)
    procs = _spawn(WORLDS, out_dirs)
    try:
        # meanwhile: the references
        plans = {k: ttp.build_tile_plan(ids[k], grids[k].shape, device="cpu")
                 for k in ("entries", "closed")}
        port = {}
        for g, tp in plans.items():
            for dt in worker.DTYPES:
                x = torch.as_tensor(data[dt])
                port[f"up.{g}.{dt}"] = tp.accumulate(x).numpy()
                port[f"down.{g}.{dt}"] = tp.accumulate_down(x).numpy()
        # the 256-row plans as each world builds them (the padded one keyed by
        # its world size), unsharded, and the JAX plan of 256-row tiles
        tall = {}
        for w in WORLDS:
            mesh_w = SimpleNamespace(size=w, device=torch.device("cpu"))
            for kind, tp in worker.tall_plans(inputs, mesh_w).items():
                for dt in worker.DTYPES:
                    x = torch.as_tensor(worker.tall_data(data[dt], codes.shape, tp.shape))
                    tall[f"{w}.{kind}.up.{dt}"] = tp.accumulate(x).numpy()
                    tall[f"{w}.{kind}.down.{dt}"] = tp.accumulate_down(x).numpy()
        jtall = jtpm.build_tile_plan(ids["entries"], codes.shape, tile_rows=256)
        wj = jnp.asarray(data["int64"])
        tall["jax.up"] = np.asarray(jax.jit(jtall.accumulate)(wj, jtall.arrays()))
        tall["jax.down"] = np.asarray(jax.jit(jtall.accumulate_down)(wj, jtall.down_arrays()))
        jtp = jtpm.build_tile_plan(ids["entries"], codes.shape)
        mesh2 = jmake_mesh(2)
        wj, fj = jnp.asarray(data["int64"]), jnp.asarray(data["float64"])
        # each JAX sweep compiled as one program, the plan's arrays passed as
        # arguments where it takes them: called eagerly, shard_map compiles
        # every operation of its body apart (about 50 s a sweep)
        jax_ref = {
            "up.sharded": jax.jit(lambda v: jtp.accumulate_sharded(v, mesh2))(wj),
            "down.sharded": jax.jit(lambda v: jtp.accumulate_down_sharded(v, mesh2))(wj),
            "up.int": jax.jit(jtp.accumulate)(wj, jtp.arrays()),
            "down.int": jax.jit(jtp.accumulate_down)(wj, jtp.down_arrays()),
            "up.float64": jax.jit(jtp.accumulate)(fj, jtp.arrays()),
            "down.float64": jax.jit(jtp.accumulate_down)(fj, jtp.down_arrays()),
        }
        jax_ref = {k: np.asarray(v) for k, v in jax_ref.items()}
    finally:
        _join(procs)
    ranks = {w: [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(w)]
             for w, d in zip(WORLDS, out_dirs)}
    seq = runtime.dfs_preorder(ids["closed"])[0]
    return dict(ranks=ranks, port=port, jax=jax_ref, plans=plans, data=data, ids=ids,
                codes=codes, closed_seq=seq, tall=tall)


def _close64(got, want, tp, total, what):
    length = 2 * (128 * 128 + tp.coarse.dfs.preorder_np.size)
    atol = 2 * length * _EPS * total
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=atol, err_msg=what)


def _check_result(sharded, world, key, ref_key, direction, grid, dt):
    ranks = sharded["ranks"][world]
    got = ranks[0][key]
    for r in range(1, world):
        assert np.array_equal(ranks[r][key], got), f"rank {r} differs from rank 0"
    want = sharded["port"][ref_key]
    assert got.dtype == want.dtype == np.dtype(dt)
    assert np.array_equal(got, want), "differs from the port's unsharded sweep"
    if grid == "entries":
        jx = sharded["jax"]
        if dt == "float64":
            _close64(got, jx[f"{direction}.float64"], sharded["plans"][grid],
                     float(np.abs(sharded["data"][dt]).sum()), "float64 of the JAX sweep")
        else:
            assert np.array_equal(got.astype(np.int64), jx[f"{direction}.sharded"])
            assert np.array_equal(got.astype(np.int64), jx[f"{direction}.int"])
    elif dt != "float64":  # closed tiles: the native sequential sweeps
        ids, seq = sharded["ids"]["closed"], sharded["closed_seq"]
        x = sharded["data"][dt].astype(np.float64)
        sweep = runtime.accuflux_sweep if direction == "up" else runtime.downward_sweep
        valid = ids >= 0
        assert np.array_equal(got[valid], sweep(ids, seq, x)[valid].astype(dt))


@pytest.mark.parametrize("chunks", worker.CHUNKS)
@pytest.mark.parametrize("dt", worker.DTYPES)
@pytest.mark.parametrize("grid", ["entries", "closed"])
@pytest.mark.parametrize("world", WORLDS)
def test_accumulate_sharded(sharded, world, grid, dt, chunks):
    _check_result(sharded, world, f"up.{grid}.{dt}.{chunks}", f"up.{grid}.{dt}", "up", grid, dt)


@pytest.mark.parametrize("dt", worker.DTYPES)
@pytest.mark.parametrize("grid", ["entries", "closed"])
@pytest.mark.parametrize("world", WORLDS)
def test_accumulate_down_sharded(sharded, world, grid, dt):
    _check_result(sharded, world, f"down.{grid}.{dt}", f"down.{grid}.{dt}", "down", grid, dt)


@pytest.mark.parametrize("dt", worker.DTYPES)
@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("kind", ["direct", "padded"])
@pytest.mark.parametrize("world", WORLDS)
def test_tall_tiles_sharded(sharded, world, kind, direction, dt):
    """Plans of 256-row tiles (``build_tile_plan(tile_rows=256)`` and
    ``parallel.build_sharded_plan(tile_rows=256)``): the sharded sweeps on
    every rank bitwise the same plan's unsharded sweep (4 ranks cut the
    grid's plan mid tile row); integers on the grid bitwise the JAX plan of
    256-row tiles (its sums in int64)."""
    ranks = sharded["ranks"][world]
    key = f"tall.{kind}.{direction}.{dt}"
    got = ranks[0][key]
    for r in range(1, world):
        assert np.array_equal(ranks[r][key], got), f"rank {r} differs from rank 0"
    want = sharded["tall"][f"{world}.{kind}.{direction}.{dt}"]
    assert got.dtype == want.dtype == np.dtype(dt) and np.array_equal(got, want)
    if dt != "float64":
        H, W = sharded["codes"].shape
        assert W % 128 == 0  # the padded plan pads rows only
        assert np.array_equal(got.reshape(-1, W)[:H].ravel().astype(np.int64),
                              sharded["tall"][f"jax.{direction}"])


@pytest.mark.parametrize("world", WORLDS)
def test_tiled_accumulate_plan(sharded, world):
    """method="plan" pads the grid to whole tile-row slabs per rank; float32
    out of float64 sums, against the native sweep."""
    got = sharded["ranks"][world][0]["plan"]
    codes = sharded["codes"]
    ids = sharded["ids"]["entries"]
    x = sharded["data"]["float32"]
    want = runtime.accuflux_sweep(ids, runtime.dfs_preorder(ids)[0], x.ravel().astype(np.float64))
    valid = (ids >= 0).reshape(codes.shape)
    assert got.dtype == np.float32 and got.shape == codes.shape
    # the float32 rounding of float64 sums taken in another order
    length = 2 * (128 * 128 + sharded["plans"]["entries"].coarse.dfs.preorder_np.size)
    np.testing.assert_allclose(got[valid], want.reshape(codes.shape)[valid], rtol=1e-6,
                               atol=2 * length * _EPS * float(x.sum(dtype=np.float64)))


@pytest.mark.parametrize("world", WORLDS)
def test_tiles_must_divide_over_the_ranks(sharded, world):
    """NT = 6 splits over 1 and 2 ranks, not over 4: ValueError on every rank."""
    for res in sharded["ranks"][world]:
        assert bool(res["odd_raised"]) == (6 % world != 0)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shapes(sharded, world):
    """The JAX layout: (1, 2) for 2 ranks, (2, 2) for 4 (and (2, 4) for 8);
    a subgroup of the first n ranks, None on the others."""
    shapes = {1: (1, 1), 2: (1, 2), 3: (1, 3), 4: (2, 2)}
    for r, res in enumerate(sharded["ranks"][world]):
        assert tuple(res["mesh_shape"]) == shapes[world]
        for n in range(1, world + 1):
            assert tuple(res[f"mesh_shape.{n}"]) == (shapes[n] if r < n else (0, 0))
    assert parallel.tiled._grid_shape(8) == (2, 4)


def test_one_process_without_a_group(sharded):
    """A mesh of the one process, no process group started: the gathers are
    copies, the results the unsharded sweeps'."""
    assert not parallel.init_distributed()  # nothing to join
    mesh = parallel.make_mesh(device="cpu")
    assert mesh.group is None and (mesh.rank, mesh.size, mesh.shape) == (0, 1, (1, 1))
    tp = sharded["plans"]["entries"]
    x = torch.as_tensor(sharded["data"]["int32"])
    assert np.array_equal(tp.accumulate_sharded(x, mesh).numpy(),
                          sharded["port"]["up.entries.int32"])
    assert np.array_equal(tp.accumulate_down_sharded(x, mesh).numpy(),
                          sharded["port"]["down.entries.int32"])
    with pytest.raises(ValueError):
        parallel.make_mesh(2, device="cpu")


def test_entry_points_take_the_card(sharded):
    """Without a GPU, a mesh on the default device raises; on the CPU mesh
    the halo runtime runs (the JAX default ``method="coarse"`` and
    ``"iterate"`` give the plan's unit sums, ``tiled_rank`` the graph's
    rank), and ``build_sharded_plan`` takes the JAX tile heights: at 256 rows
    the JAX package's padding and plan, another height the JAX
    ValueError."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    with pytest.raises(RuntimeError):
        parallel.make_mesh()
    mesh = parallel.make_mesh(device="cpu")
    codes = sharded["codes"]
    ids = sharded["ids"]["entries"]
    valid = (ids >= 0).reshape(codes.shape)
    want = sharded["plans"]["entries"].accumulate(
        torch.as_tensor(valid.ravel().astype(np.int32))).numpy().reshape(codes.shape)
    for method in ("coarse", "iterate"):
        got = parallel.tiled_accumulate(codes, np.ones(codes.shape), mesh, method=method)
        assert np.array_equal(got[valid], want[valid].astype(np.float32))
    from pyflwdir_tpu.parallel import build_sharded_plan as jbuild

    tp, pshape = parallel.build_sharded_plan(codes, mesh, tile_rows=256)
    jtp, jpshape = jbuild(codes, jmake_mesh(1), tile_rows=256)
    assert tuple(pshape) == tuple(jpshape) == (512, 512) and tp.Y == jtp.Y == 256
    for f in ("grid", "NT", "R_pad", "E_pad", "far_mode", "b"):
        assert getattr(tp, f) == getattr(jtp, f), f
    ones = np.ones(pshape[0] * pshape[1], np.int32)
    want = np.asarray(jax.jit(jtp.accumulate)(jnp.asarray(ones), jtp.arrays()))
    assert np.array_equal(tp.accumulate_sharded(torch.as_tensor(ones), mesh).numpy(), want)
    with pytest.raises(ValueError, match="multiple of 128"):
        parallel.build_sharded_plan(codes, mesh, tile_rows=200)
    from pyflwdir_torch.ops import graph as tgraph

    assert np.array_equal(parallel.tiled_rank(codes, mesh).ravel(),
                          tgraph.rank(torch.as_tensor(ids)).numpy())
