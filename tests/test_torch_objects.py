"""The object surface of ``Flwdir`` / ``FlwdirRaster`` against the JAX
package's, on the CPU: snapping indices to streams (``basins(xy=...,
streams=...)``, ``add_pits(streams=...)``), ``add_pits`` / ``repair_loops``
and the state they drop (results bitwise equal to a fresh object's,
through the 1-D plans and through the tile plan with ``_TILE_PLAN_MIN``
lowered), the cell order, ``dump`` / ``load``, ``__str__``,
``__getitem__``, coordinates, ``distnc``, ``from_dataframe`` and the
package's public names. Indices, labels and orders bitwise (int64 against
the JAX package's int32: values compared); ``distnc`` float32 bitwise."""

import numpy as np
import pytest
import torch

import pyflwdir_torch
import pyflwdir_tpu
from tests.test_torch_order import _grid

_LATLON = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)
_PROJ = (30.0, 0.0, 400000.0, 0.0, -25.0, 5800000.0)


@pytest.fixture(scope="module", params=[("d8_small", "latlon"), ("128x192", "latlon"),
                                        ("128x192", "projected")])
def rasters(request, d8_small):
    grid, tf = request.param
    d8 = d8_small if grid == "d8_small" else _grid((128, 192))
    transform, latlon = (_LATLON, True) if tf == "latlon" else (_PROJ, False)
    j = pyflwdir_tpu.from_array(d8, transform=transform, latlon=latlon)
    t = pyflwdir_torch.from_array(d8, transform=transform, latlon=latlon, device="cpu")
    return d8, j, t


def _fresh(t, ids):
    """A new port raster of ``ids`` and ``t``'s grid."""
    return pyflwdir_torch.FlwdirRaster(ids.copy(), t.shape, t.ftype, transform=t.transform,
                                       latlon=t.latlon, device="cpu")


def _stream_and_points(t, k=25, seed=9):
    stream = t.upstream_area() >= 15
    rng = np.random.RandomState(seed)
    idxs = rng.choice(np.flatnonzero(t.mask), k, replace=False)
    return stream, idxs


def test_snap_to_streams_bitwise(rasters):
    _, j, t = rasters
    stream, idxs = _stream_and_points(t)
    got = t._check_idxs_xy(idxs, None, stream)
    want = j._check_idxs_xy(idxs, None, stream)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    pit = t.idxs_ds[got] == got
    assert np.all(stream.ravel()[got] | pit)
    xs, ys = t.xy(idxs)
    assert np.array_equal(t._check_idxs_xy(None, (xs, ys), stream), got)
    # the graph object snaps the same way
    tf = pyflwdir_torch.Flwdir(t.idxs_ds, device="cpu")
    jf = pyflwdir_tpu.Flwdir(j.idxs_ds)
    assert np.array_equal(tf._check_idxs_xy(idxs, streams=stream.ravel()),
                          jf._check_idxs_xy(idxs, streams=stream.ravel()))
    with pytest.raises(ValueError):
        t._check_idxs_xy(idxs, (xs, ys))


def test_basins_xy_streams_bitwise(rasters):
    _, j, t = rasters
    stream, idxs = _stream_and_points(t, seed=10)
    xs, ys = t.xy(idxs)
    got = t.basins(xy=(xs, ys), streams=stream)
    want = j.basins(xy=(xs, ys), streams=stream)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ids = np.arange(1, idxs.size + 1) * 3
    assert np.array_equal(t.basins(idxs=idxs, streams=stream, ids=ids),
                          j.basins(idxs=idxs, streams=stream, ids=ids))


def test_add_pits_streams_bitwise(rasters):
    d8, j0, t0 = rasters
    j = pyflwdir_tpu.from_array(d8, transform=j0.transform, latlon=j0.latlon)
    t = _fresh(t0, t0.idxs_ds)
    stream, idxs = _stream_and_points(t, seed=11)
    xs, ys = t.xy(idxs)
    t.upstream_area()
    j.add_pits(xy=(xs, ys), streams=stream)
    t.add_pits(xy=(xs, ys), streams=stream)
    assert np.array_equal(t.idxs_ds, j.idxs_ds)
    assert np.array_equal(t.idxs_pit, j.idxs_pit)
    assert np.array_equal(t.upstream_area(), j.upstream_area())
    assert np.array_equal(t.basins(), j.basins())


def _stale_check(t, fresh):
    assert np.array_equal(t.upstream_area(), fresh.upstream_area())
    assert np.array_equal(t.basins(), fresh.basins())
    assert np.array_equal(t.rank, fresh.rank)
    assert np.array_equal(t.idxs_seq, fresh.idxs_seq)
    assert np.array_equal(t.stream_order(), fresh.stream_order())
    assert np.array_equal(t.idxs_us_main, fresh.idxs_us_main)


@pytest.mark.parametrize("tile_plan", [False, True])
def test_add_pits_drops_every_state(rasters, tile_plan):
    _, _, t0 = rasters
    t = _fresh(t0, t0.idxs_ds)
    if tile_plan:
        t._TILE_PLAN_MIN = 0
    # fill the caches: plans, rank, tree, orders, main upstream cells
    t.upstream_area(), t.basins(), t.stream_order(), t.idxs_us_main, t.idxs_seq
    t.stream_distance()
    assert any(k in t._cached for k in ("tile_plan", "accel", "plan"))
    idxs = np.flatnonzero(t.rank.ravel() > 3)[::17]
    t.add_pits(idxs=idxs)
    assert t._cached == {} or set(t._cached) <= {"rank"}
    ids = t0.idxs_ds.copy()
    ids[idxs] = idxs
    fresh = _fresh(t0, ids)
    if tile_plan:
        fresh._TILE_PLAN_MIN = 0
    assert np.array_equal(t.idxs_pit, fresh.idxs_pit)
    _stale_check(t, fresh)
    assert t.nnodes == fresh.nnodes


def _loop_ids(t):
    """``t``'s graph with a 2-cycle: a cell and its downstream cell point at
    each other."""
    ids = t.idxs_ds.copy()
    nonpit = np.flatnonzero(t.rank.ravel() > 1)
    a = int(nonpit[len(nonpit) // 2])
    ids[ids[a]] = a
    return ids


def test_repair_loops_bitwise(rasters):
    _, j0, t0 = rasters
    ids = _loop_ids(t0)
    t = _fresh(t0, ids)
    j = pyflwdir_tpu.FlwdirRaster(ids.astype(j0.idxs_ds.dtype), j0.shape, j0.ftype,
                                  transform=j0.transform, latlon=j0.latlon)
    assert not t.isvalid and not j.isvalid
    assert np.array_equal(t.rank, j.rank)
    t.upstream_area(), t.basins()
    t.repair_loops()
    j.repair_loops()
    assert t.isvalid and j.isvalid
    assert np.array_equal(t.idxs_ds, j.idxs_ds)
    assert np.array_equal(t.idxs_pit, j.idxs_pit)
    assert np.array_equal(t.upstream_area(), j.upstream_area())
    _stale_check(t, _fresh(t0, t.idxs_ds))


def test_cell_order_bitwise(rasters):
    _, j, t = rasters
    seq = t.idxs_seq
    assert seq.dtype == np.int64 and np.array_equal(seq, j.idxs_seq)
    ids = t.idxs_ds
    pos = np.full(t.size, -1)
    pos[seq] = np.arange(seq.size)
    assert np.all(pos[ids[seq]] <= pos[seq])  # downstream cells first
    t.order_cells(method="walk")
    assert np.array_equal(t.idxs_seq, seq)
    with pytest.raises(ValueError):
        t.order_cells(method="bfs")
    assert t.isvalid and t.ncells == j.ncells == int((t.rank >= 0).sum())


def test_coordinates_and_distnc(rasters):
    _, j, t = rasters
    idxs = np.arange(0, t.size, 7)
    for a, b in zip(t.xy(idxs), j.xy(idxs)):
        assert np.array_equal(a, b)
    assert np.array_equal(t.bounds, j.bounds) and np.array_equal(t.extent, j.extent)
    d = t.distnc
    assert d.dtype == np.float32 and np.array_equal(d, j.distnc)
    assert t.distnc is d  # cached
    assert np.array_equal(pyflwdir_torch.Flwdir(t.idxs_ds, device="cpu").distnc,
                          pyflwdir_tpu.Flwdir(j.idxs_ds).distnc)


def test_dump_load_str_getitem(rasters, tmp_path):
    _, j, t = rasters
    t.idxs_seq  # dump carries the cell order
    fn = str(tmp_path / "flw.pkl")
    t.dump(fn)
    t2 = pyflwdir_torch.FlwdirRaster.load(fn, device="cpu")
    assert np.array_equal(t2.idxs_ds, t.idxs_ds) and t2.shape == t.shape
    assert t2.ftype == t.ftype and tuple(t2.transform) == tuple(t.transform)
    assert t2.latlon == t.latlon and t2.device.type == "cpu"
    assert np.array_equal(t2.idxs_seq, t.idxs_seq)
    assert np.array_equal(t2.upstream_area(), t.upstream_area())
    d = t._dict
    assert all(not isinstance(v, torch.Tensor) for v in d.values())
    assert set(d) == set(j._dict)
    assert str(t).startswith("{") and "idxs_ds" in str(t)
    assert np.array_equal(t[[0, 5, 9]], j[[0, 5, 9]])
    fl = pyflwdir_torch.Flwdir(t.idxs_ds, device="cpu")
    fl.dump(fn)
    fl2 = pyflwdir_torch.Flwdir.load(fn, device="cpu")
    assert np.array_equal(fl2.idxs_ds, fl.idxs_ds) and fl2.nnodes == fl.nnodes
    assert set(fl._dict) == set(pyflwdir_tpu.Flwdir(j.idxs_ds)._dict)


def test_from_dataframe_bitwise():
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(3)
    ids = rng.permutation(np.arange(100, 160))
    ds = np.where(rng.rand(ids.size) < 0.1, 9999, rng.choice(ids, ids.size))
    ds[:3] = ids[3:6]  # a chain
    df = pd.DataFrame({"idx_ds": ds}, index=ids)
    got = pyflwdir_torch.from_dataframe(df, device="cpu")
    want = pyflwdir_tpu.from_dataframe(df)
    assert got.idxs_ds.dtype == np.int64 and np.array_equal(got.idxs_ds, want.idxs_ds)
    assert np.array_equal(got.idxs_pit, want.idxs_pit)
    assert np.array_equal(got.rank, want.rank)


def test_public_names():
    """The port's public names are the JAX package's: ``__all__`` equal, and
    every public method of the JAX ``Flwdir`` / ``FlwdirRaster`` present
    (nothing left raising NotImplementedError on the objects)."""
    assert pyflwdir_torch.__all__ == pyflwdir_tpu.__all__
    for name in pyflwdir_tpu.__all__:
        assert hasattr(pyflwdir_torch, name), name
    assert pyflwdir_torch.__version__ == pyflwdir_tpu.__version__
    for cls in ("Flwdir", "FlwdirRaster"):
        want = {m for m in dir(getattr(pyflwdir_tpu, cls)) if not m.startswith("_")}
        got = {m for m in dir(getattr(pyflwdir_torch, cls)) if not m.startswith("_")}
        assert want <= got, (cls, sorted(want - got))
    methods = ["path", "snap", "add_pits", "repair_loops", "idxs_seq", "order_cells",
               "isvalid", "distnc", "downstream", "upstream_sum", "moving_average",
               "moving_median", "dump", "load", "_dict", "_invalidate", "__str__",
               "__getitem__", "dem_adjust", "classify_estuaries", "river_depth"]
    for m in methods:
        assert hasattr(pyflwdir_torch.Flwdir, m), m
    for m in methods + ["ncells", "xy", "bounds", "extent", "basin_bounds", "basin_outlets",
                        "vectorize", "streams", "geofeatures", "upscale", "upscale_error",
                        "ucat_outlets", "ucat_area", "ucat_volume", "subgrid_rivlen",
                        "subgrid_rivslp", "subgrid_rivavg", "subgrid_rivmed", "dem_dig_d4",
                        "floodplains"]:
        assert hasattr(pyflwdir_torch.FlwdirRaster, m), m
    import inspect

    for mod in (pyflwdir_torch.raster, pyflwdir_torch.flwdir):
        assert "NotImplementedError" not in inspect.getsource(mod), mod.__name__


def test_entry_points_default_to_the_card(d8_small, tmp_path):
    """With no GPU and no ``device``, the new entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: entry points run on it")
    t = pyflwdir_torch.from_array(d8_small, device="cpu")
    path = str(tmp_path / "ck")
    pyflwdir_torch.checkpoint.save_sharded(t, path)
    with pytest.raises(RuntimeError):
        pyflwdir_torch.checkpoint.load_sharded(path)
    with pytest.raises(RuntimeError):
        pyflwdir_torch.regions.region_bounds(t.basins())
    with pytest.raises(RuntimeError):
        pyflwdir_torch.regions.region_outlets(t.basins(), t.idxs_ds)
    fn = str(tmp_path / "flw.pkl")
    t.dump(fn)
    with pytest.raises(RuntimeError):
        pyflwdir_torch.FlwdirRaster.load(fn)
    with pytest.raises(RuntimeError):
        pyflwdir_torch.arithmetics.lstsq(np.ones((2, 3)), np.ones((2, 3)))
