"""The tile plan's per-tile tables as int16 on the device: the host tables
(int32, and the plan files) stay as they are; ``ops.tile_plan.tile_table``
casts each of a 128-row plan where it reaches the device and raises outside
int16, for the
port's build and for a JAX plan replayed (``TilePlan.from_stage_tables``)
alike. The sweeps on ``device="cpu"`` (the kernels' plain versions) run on
those int16 tables: integers bitwise equal to the JAX package, float64
within rtol 1e-12 plus 2 n eps total (sums taken in another order), as the
other tile-plan tests hold them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyflwdir_torch import dem as tdem
from pyflwdir_torch import kernels, parallel, runtime
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu.ops import tile_plan as jtpm
from tests.test_torch_tile_down import _replay

_EPS = np.finfo(np.float64).eps
_UP = {"rin", "rout", "near_end", "far_end", "ex_end", "ent_idx"}
_DOWN = {"es", "g_last", "g_prev", "n_tree", "ent_slot", "tree_of"}


def _demo_d8(shape, seed):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape) + np.add.outer(np.linspace(2, 0, shape[0]),
                                        np.linspace(2, 0, shape[1]))
    d8 = tdem.fill_depressions(z)[1]
    d8[5, 3:6] = 247  # missing cells
    return d8


def _jax_up(jtp, x):
    """The JAX plan's ``accumulate``, compiled as one program with the
    plan's arrays as arguments (called eagerly, each operation compiles
    apart)."""
    return np.asarray(jax.jit(jtp.accumulate)(jnp.asarray(x), jtp.arrays()))


def _jax_down(jtp, x):
    """The JAX plan's ``accumulate_down``, compiled as one program with the
    plan's arrays as arguments (called eagerly, each operation compiles
    apart)."""
    return np.asarray(jax.jit(jtp.accumulate_down)(jnp.asarray(x), jtp.down_arrays()))


# name: (shape, seed, _COARSE_ROUTER_MIN): the gather and the router coarse levels
_GRIDS = {"300x260": ((300, 260), 21, None), "256x256-router": ((256, 256), 8, 1)}


@pytest.fixture(scope="module", params=list(_GRIDS))
def grid(request):
    shape, seed, router_min = _GRIDS[request.param]
    d8 = _demo_d8(shape, seed)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    old = (jtpm._COARSE_ROUTER_MIN, ttp._COARSE_ROUTER_MIN)
    try:
        if router_min is not None:
            jtpm._COARSE_ROUTER_MIN = ttp._COARSE_ROUTER_MIN = router_min
        jtp = jtpm.build_tile_plan(ids, shape)
        port = ttp.build_tile_plan(ids, shape, device="cpu")
    finally:
        jtpm._COARSE_ROUTER_MIN, ttp._COARSE_ROUTER_MIN = old
    return dict(ids=ids, shape=shape, jtp=jtp, plans={"port": port, "jax": _replay(jtp)},
                seq=runtime.dfs_preorder(ids)[0])


@pytest.mark.parametrize("which", ["port", "jax"])
def test_every_table_round_trips_through_int16(grid, which):
    tp = grid["plans"][which]
    tp._ensure_down()
    assert set(tp.idx) == _UP and set(tp.down_idx) == _DOWN
    for tables, dev in ((tp.idx, tp.idx_t), (tp.down_idx, tp.down_idx_t)):
        for k, v in tables.items():
            assert v.dtype == np.int32, k  # the host tables stay int32
            # a slot, cell, entry rank or tree index, or -1; n_tree counts
            # up to 16,384 slots
            assert int(v.max()) < (1 << 14) + (k == "n_tree") and int(v.min()) >= -1, k
            want = torch.int32 if k == "n_tree" else torch.int16
            assert dev[k].dtype == want, k
            assert np.array_equal(dev[k].numpy().astype(np.int32), v), k
            if k != "n_tree":
                t16 = ttp.tile_table(v)
                assert t16.dtype == torch.int16 and t16.shape == v.shape, k
                assert np.array_equal(t16.numpy().astype(np.int32), v), k
    # the slabs of the sharded sweeps and the band slices are int16 too
    slab = tp._slab(1, 3, ("rin", "es", "n_tree", "tree_of"))
    assert [slab[k].dtype for k in ("rin", "es", "n_tree", "tree_of")] == [
        torch.int16, torch.int16, torch.int32, torch.int16]


@pytest.mark.parametrize("bad", [1 << 15, -(1 << 15) - 1, 1 << 20])
def test_int16_table_raises_outside_int16(bad):
    a = np.arange(-1, 300, dtype=np.int32).reshape(7, 43)
    assert torch.equal(ttp.tile_table(a), torch.as_tensor(a).to(torch.int16))
    edge = np.array([-(1 << 15), (1 << 15) - 1], np.int32)
    assert ttp.tile_table(edge).tolist() == edge.tolist()
    a[3, 5] = bad
    with pytest.raises(ValueError, match="outside int16"):
        ttp.tile_table(a)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_sweeps_on_int16_tables_equal_the_jax_package(grid, which):
    ids, jtp, tp = grid["ids"], grid["jtp"], grid["plans"][which]
    H, W = grid["shape"]
    x = np.random.RandomState(3).randint(-50, 1000, ids.size).astype(np.int32)
    xt = torch.as_tensor(x)
    kernels.reset_launches()
    up, down = tp.accumulate(xt), tp.accumulate_down(xt)
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert tp.idx_t["rin"].dtype == tp.down_idx_t["es"].dtype == torch.int16
    assert np.array_equal(up.numpy(), _jax_up(jtp, x))
    assert np.array_equal(down.numpy(), _jax_down(jtp, x))
    banded = tp.accumulate_banded(x.reshape(H, W), band_tile_rows=1)
    assert np.array_equal(banded.ravel(), up.numpy())
    mesh = parallel.make_mesh(device="cpu")  # one process, no group
    assert torch.equal(tp.accumulate_sharded(xt, mesh), up)
    assert torch.equal(tp.accumulate_down_sharded(xt, mesh), down)
    w = np.random.RandomState(4).rand(ids.size)
    tol = dict(rtol=1e-12, atol=2 * ids.size * _EPS * w[ids >= 0].sum())
    np.testing.assert_allclose(tp.accumulate(torch.as_tensor(w)).numpy(),
                               runtime.accuflux_sweep(ids, grid["seq"], w), **tol)
    np.testing.assert_allclose(tp.accumulate_down(torch.as_tensor(w)).numpy(),
                               runtime.downward_sweep(ids, grid["seq"], w), **tol)


def test_plain_versions_take_either_table_width(grid):
    """On CPU tensors each wrapper runs its plain version, which reads int16
    and int32 tables alike."""
    tp = grid["plans"]["port"]
    tp._ensure_down()
    wide = {k: torch.as_tensor(v) for k, v in {**tp.idx, **tp.down_idx}.items()}
    narrow = {**tp.idx_t, **tp.down_idx_t}
    x = torch.as_tensor(np.random.RandomState(5).randint(0, 9, grid["ids"].size)
                        .astype(np.int64))
    shape = tp.shape

    def run(t):
        exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], shape)
        entv = torch.ones((tp.NT, tp.E_pad), dtype=x.dtype)
        up = kernels.tile_pass_c(x, None, entv, t["ent_idx"], t["near_end"], t["far_end"],
                                 t["rout"], shape, rin=t["rin"])
        d1 = (x, t["rin"], t["es"], t["g_last"], t["g_prev"], t["n_tree"], t["ent_slot"])
        z, pk = kernels.tile_down_a(*d1, None, shape, False)
        A = torch.ones((tp.NT, tp.R_pad), dtype=x.dtype)
        fin = kernels.tile_down_fin(x, z, A, t["tree_of"], t["rout"], shape)
        abar, _ = kernels.tile_down_a(*d1, t["rout"], shape, True, tile0=0)
        lite = kernels.tile_down_lite(abar, A, t["tree_of"], t["rout"], shape, tile0=0)
        return exits, c, up, z, pk, fin, lite

    assert all(torch.equal(a, b) for a, b in zip(run(wide), run(narrow)))
