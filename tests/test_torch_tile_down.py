"""The port's downward engine against the JAX package's, on the CPU (the
kernels' plain versions; the JAX plan through its vmap path).

``TilePlan.accumulate_down``: int32 and int64 bitwise equal to the JAX plan
and to a sequential path-sum sweep; float64 within rtol 1e-12 plus
2 * n * eps * total (the port sums in another order: a difference of prefix
sums keeps their absolute error, at most about n * eps * total, on each
side). Grids: 300x260 and 260x140 (several tiles, padding, missing cells, the
gather coarse level); 256x256 with ``_COARSE_ROUTER_MIN`` lowered in both
packages (the router coarse level, kernels H1 and H0) and with
``_COARSE_SMALL_MAX`` lowered to 0 as well (the ``BigAccelPlan`` coarse
level); 256x256 whose tiles
each drain to pits of their own (no entry cells: pass D1 routed, alone). The
down indices built natively equal those replayed from the JAX plan's down
tables.

Then the raster methods on top of it (``stream_distance``, ``basins``,
``hand``, ``fillnodata(direction="up")``) above the tile-plan threshold
(lowered to 0 in both packages) and below it, and
``Flwdir.accuflux(direction="down")``; and the engines taken, with a warning,
where a tile plan cannot be built.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import dem as tdem
from pyflwdir_torch import kernels, runtime
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import accel_big as tbig
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu.ops import tile_plan as jtpm

_EPS = np.finfo(np.float64).eps
_LATLON = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)


def _demo_d8(shape, seed):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    d8 = tdem.fill_depressions(z)[1]
    d8[1, 2:5] = 247  # missing cells
    return d8


def _closed_tiles(shape=(256, 256)):
    """Every cell flows east to a pit in the last column of its tile: no
    flow crosses a tile edge, so the plan has no entry cells."""
    d8 = np.ones(shape, np.uint8)
    d8[:, 127::128] = 0
    d8[5, 3:6] = 247
    return d8


def _replay(jtp):
    """The port's plan from the JAX plan's host arrays, down tables included."""
    jtp._ensure_down()
    cfg = dict(shape=jtp.shape, tile_rows=jtp.Y, far_mode=jtp.far_mode, b=jtp.b,
               R_pad=jtp.R_pad, E_pad=jtp.E_pad, F_rows=jtp.F_rows,
               has_far=jtp.has_far, has_entries=jtp.has_entries)
    dfs = jtp._coarse_dfs
    router = not isinstance(jtp.coarse, jtpm._CoarseGather)
    down = dict(tabs=jtp._down["tabs"], cd=jtp._down["cd"],
                routers=jtp.coarse.down_router_tables() if router else None)
    return ttp.TilePlan.from_stage_tables(
        jtp._tabs_np, cfg, jtp._coarse_meta, (dfs.preorder_np, dfs.pos_np, dfs.size_np),
        routers=jtp.coarse.router_tables() if router else None, down=down, device="cpu")


# name: (grid, _COARSE_ROUTER_MIN, _COARSE_SMALL_MAX, coarse level, has entries)
_GRIDS = {
    "300x260": (lambda: _demo_d8((300, 260), 21), None, None, "_CoarseGather", True),
    "260x140": (lambda: _demo_d8((260, 140), 31), None, None, "_CoarseGather", True),
    "256x256-router": (lambda: _demo_d8((256, 256), 8), 1, None, "_CoarseRouterSmall", True),
    "256x256-big": (lambda: _demo_d8((256, 256), 8), 1, 0, "BigAccelPlan", True),
    "closed-tiles": (_closed_tiles, None, None, "_CoarseGather", False),
}


@pytest.fixture(scope="module", params=list(_GRIDS))
def plans(request):
    make, router_min, small_max, coarse_kind, has_entries = _GRIDS[request.param]
    d8 = make()
    ids = td8.from_array(d8, dtype=np.int64)[0]
    new = {"_COARSE_ROUTER_MIN": router_min, "_COARSE_SMALL_MAX": small_max}
    old = {k: (getattr(jtpm, k), getattr(ttp, k)) for k in new}
    try:
        for k, v in new.items():
            if v is not None:
                setattr(jtpm, k, v)
                setattr(ttp, k, v)
        jtp = jtpm.build_tile_plan(ids, d8.shape)
        tp = ttp.build_tile_plan(ids, d8.shape, device="cpu")
    finally:
        for k, (j, t) in old.items():
            setattr(jtpm, k, j)
            setattr(ttp, k, t)
    assert type(jtp.coarse).__name__ == type(tp.coarse).__name__ == coarse_kind
    assert jtp.has_entries == tp.has_entries == has_entries
    seq = runtime.dfs_preorder(ids)[0]  # downstream cells before upstream ones
    return dict(ids=ids, shape=d8.shape, jtp=jtp, tp=tp, rtp=_replay(jtp), seq=seq)


def _sweep(plans, w):
    """Sequential path sums (float64; exact for the small integers here)."""
    return runtime.downward_sweep(plans["ids"], plans["seq"], w)


def _jax_down(jtp, x):
    """The JAX plan's ``accumulate_down``, compiled as one program with the
    plan's arrays as arguments (called eagerly, each operation compiles
    apart)."""
    return np.asarray(jax.jit(jtp.accumulate_down)(jnp.asarray(x), jtp.down_arrays()))


def _int_data(kind, n):
    rng = np.random.RandomState(5)
    return {"ones": np.ones(n, np.int32),
            "int32": rng.randint(-50, 1000, n).astype(np.int32),
            # |max| * n >= 2^31: the port accumulates in int64
            "int64_wide": rng.randint(0, 1 << 20, n).astype(np.int64)}[kind]


@pytest.mark.parametrize("kind", ["ones", "int32", "int64_wide"])
def test_accumulate_down_int_bitwise(plans, kind):
    ids, jtp, tp, rtp = plans["ids"], plans["jtp"], plans["tp"], plans["rtp"]
    data = _int_data(kind, ids.size)
    assert tp._acc_dtype(torch.as_tensor(data)) == (
        torch.int64 if kind == "int64_wide" else torch.int32)
    kernels.reset_launches()
    got = tp.accumulate_down(torch.as_tensor(data))
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert got.dtype == torch.as_tensor(data).dtype
    got = got.numpy()
    assert np.array_equal(got, _jax_down(jtp, data))
    assert np.array_equal(got, _sweep(plans, data).astype(data.dtype))
    assert np.array_equal(rtp.accumulate_down(torch.as_tensor(data)).numpy(), got)
    # missing cells pass their values through
    assert np.array_equal(got[ids < 0], data[ids < 0])


def test_accumulate_down_float64_close(plans):
    ids, jtp, tp = plans["ids"], plans["jtp"], plans["tp"]
    w = np.random.RandomState(7).rand(ids.size)
    got = tp.accumulate_down(torch.as_tensor(w))
    assert got.dtype == torch.float64
    # the same bits from run to run
    assert torch.equal(got, tp.accumulate_down(torch.as_tensor(w)))
    got = got.numpy()
    tol = dict(rtol=1e-12, atol=2 * ids.size * _EPS * w[ids >= 0].sum())
    np.testing.assert_allclose(got, _sweep(plans, w), **tol)
    if isinstance(jtp.coarse, jtpm._CoarseGather):
        # the JAX router coarse level rounds float input to float32
        np.testing.assert_allclose(got, _jax_down(jtp, w), **tol)
    assert np.array_equal(got[ids < 0], w[ids < 0])
    # float32 data comes back float32, summed in float64
    got32 = tp.accumulate_down(torch.as_tensor(w.astype(np.float32)))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), _sweep(plans, w.astype(np.float32)), rtol=1.2e-7)


def test_accumulate_down_is_the_transpose_of_accumulate(plans):
    ids, tp = plans["ids"], plans["tp"]
    rng = np.random.RandomState(5)
    valid = ids >= 0
    x = np.where(valid, rng.randint(0, 9, ids.size), 0).astype(np.int64)
    y = np.where(valid, rng.randint(0, 9, ids.size), 0).astype(np.int64)
    Sx = tp.accumulate(torch.as_tensor(x)).numpy()
    STy = tp.accumulate_down(torch.as_tensor(y)).numpy()
    assert np.dot(Sx, y) == np.dot(x, STy)


def test_down_indices_equal_the_replayed_jax_tables(plans):
    tp, rtp = plans["tp"], plans["rtp"]
    tp._ensure_down()
    rtp._ensure_down()
    assert set(tp.down_idx) == set(rtp.down_idx) == {
        "es", "g_last", "g_prev", "n_tree", "ent_slot", "tree_of"}
    for k in tp.down_idx:
        assert tp.down_idx[k].dtype == rtp.down_idx[k].dtype == np.int32, k
        assert np.array_equal(tp.down_idx[k], rtp.down_idx[k]), k
    assert tp.down_idx["ent_slot"].shape == (tp.NT, tp.E_pad)
    # each real entry's slot is where ent_idx first counts it
    es, ei = tp.down_idx["ent_slot"], tp.idx["ent_idx"]
    t, j = np.nonzero(es >= 0)
    assert np.array_equal(ei[t, es[t, j]], j)
    assert set(tp.coarse.down) == set(rtp.coarse.down) == {
        "es_in", "g_last", "g_prev", "win_next", "rev", "fin"}
    for k in tp.coarse.down:
        assert np.array_equal(tp.coarse.down[k], rtp.coarse.down[k]), k


def test_dispatch_follows_the_jax_plan(plans, monkeypatch):
    """Raw D1, the coarse level and D2 where the plan has entry cells; else
    the routed D1 alone."""
    tp = plans["tp"]
    calls = []
    for name in ("tile_down_a", "tile_down_fin"):
        real = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _r=real, _n=name: (
            calls.append((_n, a[-1]) if _n == "tile_down_a" else (_n,)) or _r(*a)))
    coarse_calls = []
    real_cd = type(tp.coarse).accumulate_down
    monkeypatch.setattr(type(tp.coarse), "accumulate_down",
                        lambda self, pkf: coarse_calls.append(pkf.numel()) or real_cd(self, pkf))
    tp.accumulate_down(torch.ones(tp.shape[0] * tp.shape[1], dtype=torch.int32))
    if tp.has_entries:
        assert calls == [("tile_down_a", False), ("tile_down_fin",)]
        assert coarse_calls == [tp.NT * tp.E_pad]
    else:
        assert calls == [("tile_down_a", True)] and coarse_calls == []
        assert tp.E_pad == 0


def test_a_plan_loaded_without_down_tables_raises(plans):
    jtp = plans["jtp"]
    cfg = dict(shape=jtp.shape, tile_rows=jtp.Y, far_mode=jtp.far_mode, b=jtp.b,
               R_pad=jtp.R_pad, E_pad=jtp.E_pad, F_rows=jtp.F_rows,
               has_far=jtp.has_far, has_entries=jtp.has_entries)
    dfs = jtp._coarse_dfs
    routers = None if isinstance(jtp.coarse, jtpm._CoarseGather) else jtp.coarse.router_tables()
    tp = ttp.TilePlan.from_stage_tables(
        jtp._tabs_np, cfg, jtp._coarse_meta, (dfs.preorder_np, dfs.pos_np, dfs.size_np),
        routers=routers, device="cpu")
    with pytest.raises(RuntimeError, match="downward"):
        tp.accumulate_down(torch.ones(jtp.shape[0] * jtp.shape[1], dtype=torch.int32))


def test_the_three_coarse_levels_agree(monkeypatch):
    """One grid through the port's gather, single-chunk and BigAccelPlan
    coarse levels: upward and downward bitwise equal, int32 and int64."""
    d8 = _demo_d8((256, 256), 8)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    tps = {}
    for kind, (router_min, small_max) in (("_CoarseGather", (200_000, 1_870_000)),
                                          ("_CoarseRouterSmall", (1, 1_870_000)),
                                          ("BigAccelPlan", (1, 0))):
        monkeypatch.setattr(ttp, "_COARSE_ROUTER_MIN", router_min)
        monkeypatch.setattr(ttp, "_COARSE_SMALL_MAX", small_max)
        tps[kind] = ttp.build_tile_plan(ids, d8.shape, device="cpu")
        assert type(tps[kind].coarse).__name__ == kind
    big = tps["BigAccelPlan"].coarse
    assert big.slot_mode and big.n_pad == 1 << 21 and big._n_down(0) == big.n_pad
    for kind in ("int32", "int64_wide"):
        x = torch.as_tensor(_int_data(kind, ids.size))
        up = tps["_CoarseGather"].accumulate(x)
        down = tps["_CoarseGather"].accumulate_down(x)
        for name in ("_CoarseRouterSmall", "BigAccelPlan"):
            assert torch.equal(tps[name].accumulate(x), up), (name, kind)
            assert torch.equal(tps[name].accumulate_down(x), down), (name, kind)
    w = torch.as_tensor(np.random.RandomState(7).rand(ids.size))
    tol = dict(rtol=1e-12, atol=2 * ids.size * _EPS * float(w.sum()))
    np.testing.assert_allclose(tps["BigAccelPlan"].accumulate(w).numpy(),
                               tps["_CoarseGather"].accumulate(w).numpy(), **tol)
    np.testing.assert_allclose(tps["BigAccelPlan"].accumulate_down(w).numpy(),
                               tps["_CoarseGather"].accumulate_down(w).numpy(), **tol)


# ---------------------------------------------------------------------------
# the raster methods on top of it
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def d8_raster():
    return _demo_d8((260, 140), 31)


@pytest.fixture(params=["tile-plan", "graph"])
def pair(request, d8_raster, monkeypatch):
    """The two packages' rasters of one grid, above the tile-plan threshold
    (lowered to 0) or below it (the default)."""
    t = pyflwdir_torch.from_array(d8_raster, transform=_LATLON, latlon=True, device="cpu")
    j = pyflwdir_tpu.from_array(d8_raster, transform=_LATLON, latlon=True)
    if request.param == "tile-plan":
        monkeypatch.setattr(type(t), "_TILE_PLAN_MIN", 0)
        monkeypatch.setattr(type(j), "_TILE_PLAN_MIN", 0)
    spy = []
    real = ttp.TilePlan.accumulate_down
    monkeypatch.setattr(ttp.TilePlan, "accumulate_down",
                        lambda self, data: spy.append(data.dtype) or real(self, data))
    return t, j, spy, request.param == "tile-plan"


@pytest.mark.parametrize("with_mask", [False, True])
def test_stream_distance_cells_bitwise(pair, with_mask):
    t, j, spy, tiled = pair
    mask = (np.random.RandomState(1).rand(*t.shape) < 0.02) if with_mask else None
    got, want = t.stream_distance(mask=mask), j.stream_distance(mask=mask)
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got[t.mask.reshape(t.shape) & (mask is None)],
                          t.rank[t.mask.reshape(t.shape) & (mask is None)])
    assert spy == ([torch.int32] if tiled else [])


@pytest.mark.parametrize("with_mask", [False, True])
def test_stream_distance_metres_close(pair, with_mask):
    t, j, spy, tiled = pair
    mask = (np.random.RandomState(1).rand(*t.shape) < 0.02) if with_mask else None
    got = t.stream_distance(mask=mask, unit="m")
    want = j.stream_distance(mask=mask, unit="m")
    assert got.dtype == want.dtype == np.float32
    # float32 results of sums taken in float64 (tile plan) or float32 (graph)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert spy == ([torch.float32] if tiled else [])
    with pytest.raises(ValueError, match="Unknown unit"):
        t.stream_distance(unit="km")


@pytest.mark.parametrize("kind", ["pits", "idxs", "ids", "xy"])
def test_basins(pair, kind):
    t, j, spy, tiled = pair
    rng = np.random.RandomState(2)
    idxs = rng.choice(np.nonzero(t.mask)[0], 40, replace=False)
    kw = {"pits": {}, "idxs": dict(idxs=idxs),
          "ids": dict(idxs=idxs, ids=rng.permutation(1000)[:40].astype(np.int64) + 1),
          "xy": dict(xy=(np.array([5.5, 6.0]), np.array([51.0, 50.2])))}[kind]
    got, want = t.basins(**kw), j.basins(**kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    if kind == "pits":  # constant along every flow path
        flat = got.ravel()
        assert np.array_equal(flat[t.mask], flat[t.idxs_ds[t.mask]])
        assert (flat[t.mask] > 0).all() and (flat[~t.mask] == 0).all()
    assert spy == ([torch.int32] if tiled else [])


def test_basins_argument_checks(pair):
    t = pair[0]
    with pytest.raises(ValueError, match="size"):
        t.basins(idxs=[3, 4], ids=[1])
    with pytest.raises(ValueError, match="zero"):
        t.basins(idxs=[3, 4], ids=[0, 1])
    with pytest.raises(ValueError, match="Either"):
        t.basins(idxs=[3], xy=([5.5], [51.0]))


def test_basins_ids_past_int32_take_the_graph_path(pair):
    t, j, spy, _ = pair
    idxs = t.idxs_pit[:3]
    ids = np.array([2**31 + 5, 7, 9], dtype=np.int64)
    assert np.array_equal(t.basins(idxs=idxs, ids=ids), j.basins(idxs=idxs, ids=ids))
    assert spy == []


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_hand(pair, dtype):
    t, j, spy, tiled = pair
    rng = np.random.RandomState(3)
    drain = t.upstream_area() > 50
    elevtn = (rng.rand(*t.shape) * 100).astype(dtype)
    got, want = t.hand(drain, elevtn), j.hand(drain, elevtn)
    assert got.dtype == want.dtype and got.shape == want.shape
    # one subtraction of two elevations: bitwise
    assert np.array_equal(got, want)
    assert (got[drain & t.mask.reshape(t.shape)] == 0).all()
    assert (got[~t.mask.reshape(t.shape)] == -9999).all()
    assert spy == ([torch.float32] if tiled else [])


@pytest.mark.parametrize("kind", ["float32", "float64", "int64_big", "int16"])
def test_fillnodata_up(pair, kind):
    t, j, spy, tiled = pair
    rng = np.random.RandomState(2)
    sel = rng.rand(*t.shape) < 0.1
    if kind == "int64_big":  # not representable in float32
        data, nodata = np.where(sel, (1 << 24) + 3, 0).astype(np.int64), 0
    elif kind == "int16":
        data, nodata = np.where(sel, rng.randint(1, 99, t.shape), -1).astype(np.int16), -1
    else:
        data, nodata = np.where(sel, rng.rand(*t.shape), -9999.0).astype(kind), -9999.0
    got = t.fillnodata(data, nodata, direction="up")
    want = j.fillnodata(data, nodata, direction="up")
    assert got.dtype == want.dtype == data.dtype and got.shape == want.shape
    # a copy of one value per cell; float64 data rides float32 on the tile plan
    assert np.array_equal(got, want)
    assert (got != nodata).sum() > (data != nodata).sum()
    first = {"float32": torch.float32, "float64": torch.float32,
             "int64_big": torch.int32, "int16": torch.int32}[kind]
    assert spy == ([first, torch.int32] if tiled else [])


def test_fillnodata_int_past_int32_sweeps_in_int64(pair):
    t, j, spy, tiled = pair
    sel = np.random.RandomState(4).rand(*t.shape) < 0.1
    data = np.where(sel, (1 << 40) + 1, 0).astype(np.int64)
    got = t.fillnodata(data, 0, direction="up")
    assert np.array_equal(got, j.fillnodata(data, 0, direction="up"))
    assert spy == ([torch.int64, torch.int32] if tiled else [])


def test_fillnodata_other_directions(pair):
    t, j = pair[0], pair[1]
    # direction="down" is no longer a later slice: against the JAX package
    # (integer values, so float32 sums are exact in any order)
    rng = np.random.RandomState(9)
    data = np.where(rng.rand(*t.shape) < 0.4, -9999.0,
                    rng.randint(1, 50, t.shape)).astype(np.float32)
    for how in ("max", "min", "sum"):
        got = t.fillnodata(data, -9999.0, direction="down", how=how)
        assert got.dtype == np.float32
        assert np.array_equal(got, j.fillnodata(data, -9999.0, direction="down", how=how))
    data = np.ones(t.shape, np.float32)
    with pytest.raises(ValueError, match="Unknown flow direction"):
        t.fillnodata(data, -9999.0, direction="sideways")


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64])
@pytest.mark.parametrize("nodata", [False, True])
def test_accuflux_down(pair, dtype, nodata):
    t, j, _, _ = pair
    rng = np.random.RandomState(8)
    data = (rng.rand(*t.shape) * 10).astype(dtype)
    if nodata:
        data[rng.rand(*t.shape) < 0.05] = -9999
    got = t.accuflux(data, direction="down")
    want = j.accuflux(data, direction="down")
    assert got.dtype == want.dtype and got.shape == want.shape
    # the same doubling rounds add the same pairs in both packages
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# where no tile plan can be built
# ---------------------------------------------------------------------------
@pytest.fixture
def no_tile_plan(d8_raster, monkeypatch):
    """The port's raster above the tile-plan threshold (lowered to 0), with a
    tile-plan build that raises as a coarse graph past the routers' capacity
    does."""
    t = pyflwdir_torch.from_array(d8_raster, transform=_LATLON, latlon=True, device="cpu")
    monkeypatch.setattr(type(t), "_TILE_PLAN_MIN", 0)

    def fail(*args, **kwargs):
        raise ValueError("coarse graph exceeds router capacity")

    monkeypatch.setattr(ttp, "build_tile_plan", fail)
    return t


def _no_engine_switch(t, call, monkeypatch):
    """``call`` raises the build's error, with no warning and no sweep on the
    host or through the 1-D plans in its place."""
    import warnings

    used = []
    for mod, name in ((runtime, "downward_sweep"), (tbig.BigAccelPlan, "accumulate"),
                      (type(t).__mro__[1], "_accumulate_dev")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: used.append(_n))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="coarse graph exceeds router capacity"):
            call(t)
    assert used == [] and "tile_plan" not in t._cached


@pytest.mark.parametrize("call", [
    lambda t: t.upstream_area(),
    lambda t: t.upstream_area("km2"),
    lambda t: t.accuflux(np.ones(t.shape, np.int64)),
], ids=["upstream_area", "upstream_area_km2", "accuflux"])
def test_failed_build_raises_upward(no_tile_plan, monkeypatch, call):
    _no_engine_switch(no_tile_plan, call, monkeypatch)


@pytest.mark.parametrize("call", [
    lambda t: t.stream_distance(),
    lambda t: t.stream_distance(mask=np.arange(t.size).reshape(t.shape) % 50 == 0),
    lambda t: t.stream_distance(mask=np.arange(t.size).reshape(t.shape) % 50 == 0, unit="m"),
    lambda t: t.basins(),
    lambda t: t.hand(np.arange(t.size).reshape(t.shape) % 50 == 0,
                     np.ones(t.shape, np.float32)),
    lambda t: t.fillnodata(np.where(np.arange(t.size).reshape(t.shape) % 9, -1, 5)
                           .astype(np.int16), -1, direction="up"),
    lambda t: t.fillnodata(np.where(np.arange(t.size).reshape(t.shape) % 9, 0, (1 << 60) + 1),
                           0, direction="up"),
], ids=["stream_distance", "stream_distance_mask", "stream_distance_m", "basins", "hand",
        "fillnodata_up", "fillnodata_up_int64"])
def test_failed_build_raises_downward(no_tile_plan, monkeypatch, call):
    _no_engine_switch(no_tile_plan, call, monkeypatch)


def test_raster_below_the_threshold_takes_the_big_plan_for_every_dtype(d8_raster, monkeypatch):
    """A raster up to the tile-plan threshold accumulates through the 1-D
    engines: where the graph does not fit the single-chunk plan, integer and
    float data both take the BigAccelPlan."""
    from pyflwdir_torch.ops import accel as taccel

    t = pyflwdir_torch.from_array(d8_raster, transform=_LATLON, latlon=True, device="cpu")
    j = pyflwdir_tpu.from_array(d8_raster, transform=_LATLON, latlon=True)
    calls = []
    real = tbig.BigAccelPlan.accumulate
    monkeypatch.setattr(tbig.BigAccelPlan, "accumulate",
                        lambda self, data: calls.append(data.dtype) or real(self, data))
    upa = t.upstream_area()  # this 36,400-cell graph fits the single-chunk plan
    assert calls == [] and np.array_equal(upa, j.upstream_area())
    monkeypatch.setattr(taccel, "build_accel_plan", lambda ids, dfs, device=None:
                        tbig.build_big_accel_plan(ids, dfs, device=device))
    t._cached.pop("accel")
    assert np.array_equal(t.upstream_area(), upa)
    km2 = t.upstream_area("km2")
    assert calls == [torch.int32, torch.float64]
    np.testing.assert_allclose(km2, j.upstream_area("km2"), rtol=1e-12,
                               atol=2 * t.size * _EPS * km2.ravel()[t.idxs_pit].sum())


def test_the_port_imports_no_jax():
    root = pathlib.Path(pyflwdir_torch.__file__).resolve().parent
    tests = root.parent / "tests"
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py",
                                          tests / "torch_sharded_worker.py",
                                          tests / "torch_halo_worker.py"]
    assert len(files) > 15
    for new in ("ops/stencil.py", "entry.py", "parallel/tiled.py", "parallel/distributed.py"):
        assert root / new in files, new
    pat = re.compile(r"^\s*(import|from)\s+(jax|pyflwdir_tpu)\b", re.M)
    for f in files:
        assert not pat.search(f.read_text()), f
