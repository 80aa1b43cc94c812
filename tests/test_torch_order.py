"""Stream order: the port's ``ops/order.py``, ``Flwdir.stream_order`` and
``FlwdirRaster.stream_order`` against the JAX package's and the native
sequential sweeps, bitwise, on the CPU.

Grids from a seeded DEM with missing cells and three border cells whose D8
code points off the grid (the child count must drop their step, as the JAX
package's rolls zero the wrapped row or column): 256x384 for the tile-plan
Strahler, with ``_TILE_PLAN_MIN`` lowered in both packages, on plans the
port built and on one the JAX package saved; 64x96 and the 15x12
``d8_small`` for the fixpoint and the classic order, which loop a round a
cell of the longest path."""

import numpy as np
import pytest
import torch

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import dem as tdem
from pyflwdir_torch import runtime
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import order as tord
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu.codecs import d8 as jd8
from pyflwdir_tpu.ops import order as jord

import jax.numpy as jnp


def _grid(shape=(256, 384)):
    H, W = shape
    rng = np.random.RandomState(17)
    z = rng.rand(H, W) + np.add.outer(np.linspace(2, 0, H), np.linspace(2, 0, W))
    d8 = tdem.fill_depressions(z)[1]
    d8[1, 2:5] = 247  # missing cells
    d8[0, 7] = 64  # north, off the grid
    d8[20, 0] = 32  # north-west, off the grid
    d8[H - 1, W // 3] = 4  # south, off the grid
    return d8


@pytest.fixture(scope="module")
def grids(d8_small):
    return {"d8_small": d8_small, "64x96": _grid((64, 96)), "256x384": _grid()}


@pytest.fixture(scope="module")
def rasters(grids):
    """The 256x384 grid as a JAX and a port raster, both taking the tile
    plan (``_TILE_PLAN_MIN`` 0 on the objects)."""
    d8 = grids["256x384"]
    j = pyflwdir_tpu.from_array(d8)
    t = pyflwdir_torch.from_array(d8, device="cpu")
    j._TILE_PLAN_MIN = t._TILE_PLAN_MIN = 0
    return d8, j, t


def _native(ids, mask=None):
    pre = runtime.dfs_preorder(ids)[0]
    return runtime.strahler_order(ids, pre, mask=mask)


@pytest.mark.parametrize("name", ["d8_small", "64x96"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_strahler_order_bitwise(grids, name, with_mask):
    ids = td8.from_array(grids[name], dtype=np.int64)[0]
    mask = (np.random.RandomState(3).rand(ids.size) < 0.9) if with_mask else None
    want = np.asarray(jord.strahler_order(jnp.asarray(ids),
                                          None if mask is None else jnp.asarray(mask)))
    got = tord.strahler_order(torch.as_tensor(ids),
                              None if mask is None else torch.as_tensor(mask)).numpy()
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    # the native sweep lets a masked cell take an order from the cells above
    # it (the fixpoint keeps it 0): equal inside the mask
    inside = np.ones(ids.size, bool) if mask is None else mask
    assert np.array_equal(got[inside], _native(ids, mask)[inside])


@pytest.mark.parametrize("with_mask", [False, True])
def test_strahler_tile_plan_bitwise(rasters, with_mask):
    from pyflwdir_tpu.ops import tile_plan as jtpm

    d8, j, t = rasters
    mask = None
    ids = t.idxs_ds
    tp, jtp = t._tile_plan(), j._tile_plan()  # the rasters' plans
    if with_mask:  # codes cut to the mask, plans of the cut graph
        mask = np.random.RandomState(4).rand(*d8.shape) < 0.97
        d8 = np.where(mask, d8, 247).astype(np.uint8)
        ids = td8.from_array(d8, dtype=np.int64)[0]
        tp = ttp.build_tile_plan(ids, d8.shape, device="cpu")
        jtp = jtpm.build_tile_plan(ids, d8.shape)
    got = tord.strahler_tile_plan(d8, tp, mask=mask).numpy()
    want = np.asarray(jord.strahler_tile_plan(d8, jtp, mask=mask))
    assert got.dtype == want.dtype == np.uint8 and got.shape == d8.shape
    assert np.array_equal(got, want)
    native = _native(ids, None if mask is None else mask.ravel()).reshape(d8.shape)
    assert np.array_equal(got, native)
    assert got.max() >= 5
    # the plan's grids are cached by the codes' identity
    grids_before = tp._strahler_grids
    assert np.array_equal(tord.strahler_tile_plan(d8, tp, mask=mask).numpy(), got)
    assert tp._strahler_grids is grids_before
    # a cap on the levels stops the orders there
    capped = tord.strahler_tile_plan(d8, tp, mask=mask, max_order=3).numpy()
    assert np.array_equal(capped, np.minimum(got, 3))


def test_raster_stream_order_takes_the_tile_plan(rasters, monkeypatch):
    d8, j, t = rasters
    levels = []
    real = ttp.TilePlan.accumulate

    def counted(self, data):
        levels.append(int(data.sum()))
        return real(self, data)

    monkeypatch.setattr(ttp.TilePlan, "accumulate", counted)
    got = t.stream_order()
    want = j.stream_order()
    assert got.dtype == want.dtype == np.uint8 and got.shape == d8.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got.ravel(), _native(t.idxs_ds))
    # one accumulation of the level's confluence cells a level
    assert len(levels) == int(got.max()) - 1 and all(n > 0 for n in levels)
    assert np.array_equal(t._cached["strord"], got.ravel())
    assert np.array_equal(t.stream_order(), got) and len(levels) == int(got.max()) - 1


def test_d8_codes_equal_to_array(rasters):
    _, _, t = rasters
    got = tord.d8_codes(t._ds, t.shape).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, jd8.to_array(t.idxs_ds, t.shape))
    bad = torch.as_tensor(np.array([5, 1, 2, 3, 4, 5], np.int64))
    with pytest.raises(ValueError, match="outside 8 neighbors"):
        tord.d8_codes(bad, (2, 3))


def test_jax_saved_plan_gives_the_same_order(rasters, tmp_path):
    d8, j, _ = rasters
    want = j.stream_order()
    j._tile_plan().save(tmp_path / "plan", down=False)
    t = pyflwdir_torch.from_array(d8, device="cpu")
    t._TILE_PLAN_MIN = 0
    t.load_plans(tmp_path / "plan")
    assert np.array_equal(t.stream_order(), want)


@pytest.mark.parametrize("name", ["d8_small", "64x96"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_classic_order_bitwise(grids, name, with_mask):
    d8 = grids[name]
    j = pyflwdir_tpu.from_array(d8)
    t = pyflwdir_torch.from_array(d8, device="cpu")
    mask = (np.random.RandomState(5).rand(*d8.shape) < 0.9) if with_mask else None
    got = t.stream_order("classic", mask=mask)
    want = j.stream_order("classic", mask=mask)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    # the native sweep over the DFS preorder
    m = None if mask is None else mask.ravel()
    nup = t.n_upstream.ravel() if m is None else np.asarray(
        pyflwdir_torch.ops.graph.upstream_count(t._ds, torch.as_tensor(m)))
    native = runtime.classic_order(t.idxs_ds, t._plan.preorder_np, t.idxs_us_main, nup, mask=m)
    assert np.array_equal(got.ravel(), native)
    # and the Strahler order of the 1-D engines below the tile threshold
    assert np.array_equal(t.stream_order(mask=mask), j.stream_order(mask=mask))


def test_main_upstream_and_counts(rasters):
    _, j, t = rasters
    assert np.array_equal(t.n_upstream, j.n_upstream)
    # the JAX tile plan's upstream_area is left out: eager, it compiles for long
    upa = t.upstream_area()
    assert np.array_equal(t.idxs_us_main, j.main_upstream(upa))
    upa = t.upstream_area("km2")
    assert np.array_equal(t.main_upstream(upa), j.main_upstream(upa))


def test_unknown_order_type_raises(rasters):
    _, _, t = rasters
    with pytest.raises(ValueError, match="stream order type"):
        t.stream_order("horton")
