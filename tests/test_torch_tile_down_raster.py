"""The raster methods on top of the port's downward engine against the JAX
package's, on the CPU (the kernels' plain versions): ``stream_distance``,
``basins``, ``hand``, ``fillnodata(direction="up")`` above the tile-plan
threshold (lowered to 0 in both packages) and below it, and
``Flwdir.accuflux(direction="down")``; the engines taken where a tile plan
cannot be built (its error raised, no other engine); and that the port
imports no JAX. The engine itself is tested in ``test_torch_tile_down.py``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import runtime
from pyflwdir_torch.ops import accel_big as tbig
from pyflwdir_torch.ops import tile_plan as ttp
from tests.test_torch_tile_down import _demo_d8

_EPS = np.finfo(np.float64).eps
_LATLON = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)


# ---------------------------------------------------------------------------
# the raster methods on top of it
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def d8_raster():
    return _demo_d8((260, 140), 31)


@pytest.fixture(scope="module", params=["tile-plan", "graph"])
def rasters(request, d8_raster):
    """The two packages' rasters of one grid, kept for the module: the plans
    their methods build (each package's tile plan among them) serve every
    test of the same kind."""
    t = pyflwdir_torch.from_array(d8_raster, transform=_LATLON, latlon=True, device="cpu")
    j = pyflwdir_tpu.from_array(d8_raster, transform=_LATLON, latlon=True)
    return t, j, request.param == "tile-plan"


@pytest.fixture
def pair(rasters, monkeypatch):
    """The rasters above the tile-plan threshold (lowered to 0) or below it
    (the default), and the dtypes of this test's calls of the port's
    ``TilePlan.accumulate_down``."""
    t, j, tiled = rasters
    if tiled:
        monkeypatch.setattr(type(t), "_TILE_PLAN_MIN", 0)
        monkeypatch.setattr(type(j), "_TILE_PLAN_MIN", 0)
    spy = []
    real = ttp.TilePlan.accumulate_down
    monkeypatch.setattr(ttp.TilePlan, "accumulate_down",
                        lambda self, data: spy.append(data.dtype) or real(self, data))
    return t, j, spy, tiled


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
