"""Regions, grid tools and checkpoints: the port's ``regions.py``,
``gridtools.py``, ``gis_utils.py``, ``checkpoint.py`` and the objects'
``basin_bounds`` / ``basin_outlets`` against the JAX package's, on the CPU.
Labels, extents, outlets, spread values and sources bitwise; bounds and
areas bitwise too (the same float64 formulas on the same extents; the
sums of ``scipy.ndimage`` on the host). A checkpoint written by either
package loads in the other, whole and by a window of tiles."""

import numpy as np
import pytest

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import checkpoint as tck
from pyflwdir_torch import gis_utils as tgis
from pyflwdir_torch import gridtools as tgt
from pyflwdir_torch import regions as treg
from pyflwdir_torch import runtime as trt
from pyflwdir_tpu import checkpoint as jck
from pyflwdir_tpu import gis_utils as jgis
from pyflwdir_tpu import gridtools as jgt
from pyflwdir_tpu import regions as jreg
from pyflwdir_tpu import runtime as jrt
from tests.test_torch_order import _grid

_LATLON = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)
_PROJ = (30.0, 0.0, 400000.0, 0.0, -25.0, 5800000.0)


@pytest.fixture(scope="module", params=["d8_small", "128x192"])
def rasters(request, d8_small):
    d8 = d8_small if request.param == "d8_small" else _grid((128, 192))
    j = pyflwdir_tpu.from_array(d8, transform=_LATLON, latlon=True)
    t = pyflwdir_torch.from_array(d8, transform=_LATLON, latlon=True, device="cpu")
    return d8, j, t


def _labels(shape, k=9, seed=1):
    """Blocky labels 0..k with holes: several regions a label, one label
    absent."""
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, k + 1, (shape[0] // 4 + 1, shape[1] // 4 + 1))
    lab = np.kron(lab, np.ones((4, 4), dtype=lab.dtype))[: shape[0], : shape[1]]
    lab[lab == 3] = 0
    return lab.astype(np.int32)


def _same_tuple(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("transform", [_LATLON, _PROJ])
def test_region_bounds_slices_bitwise(transform):
    lab = _labels((40, 57))
    _same_tuple(treg.region_bounds(lab, transform=transform, device="cpu"),
                jreg.region_bounds(lab, transform=transform))
    lt, st = treg.region_slices(lab, device="cpu")
    lj, sj = jreg.region_slices(lab)
    assert np.array_equal(lt, lj) and st == sj
    with pytest.raises(ValueError):
        treg.region_slices(np.zeros((4, 4), np.int32), device="cpu")
    with pytest.raises(ValueError):
        treg.region_bounds(lab.ravel(), device="cpu")


@pytest.mark.parametrize("latlon", [False, True])
def test_region_sum_area_bitwise(latlon):
    lab = _labels((40, 57), seed=2)
    data = np.random.RandomState(3).rand(40, 57)
    _same_tuple(treg.region_sum(data, lab), jreg.region_sum(data, lab))
    tf = _LATLON if latlon else _PROJ
    _same_tuple(treg.region_area(lab, transform=pyflwdir_torch.Affine(*tf), latlon=latlon),
                jreg.region_area(lab, transform=pyflwdir_tpu.Affine(*tf), latlon=latlon))


def test_region_outlets_and_basins_bitwise(rasters):
    _, j, t = rasters
    bas = t.basins()
    assert np.array_equal(bas, j.basins())
    for got, want in ((t.basin_outlets(bas), j.basin_outlets(bas)),
                      (t.basin_bounds(bas), j.basin_bounds(bas)),
                      (t.basin_bounds(), j.basin_bounds())):
        _same_tuple(got, want)
    lbs, out = t.basin_outlets(bas)
    assert lbs.dtype == bas.dtype and out.dtype == np.int64
    assert np.all(np.isin(out, t.idxs_pit))
    # sub-basins: outlets are cells whose downstream cell leaves the label
    sub = _labels(t.shape, k=6, seed=4) * t.mask.reshape(t.shape)
    _same_tuple(treg.region_outlets(sub, t._ds), jreg.region_outlets(sub, j.idxs_ds))
    _same_tuple(treg.region_outlets(sub, t.idxs_ds, device="cpu"),
                jreg.region_outlets(sub, j.idxs_ds))


@pytest.mark.parametrize("by", ["labels", "idxs"])
def test_region_dissolve_bitwise(by):
    lab = _labels((30, 44), seed=5)
    present = np.unique(lab[lab > 0])
    labels = present[[1, 4]]
    if by == "labels":
        kw = dict(labels=labels)
    else:
        kw = dict(idxs=np.array([np.flatnonzero(lab.ravel() == v)[0] for v in labels]))
    got = treg.region_dissolve(lab, **kw)
    assert np.array_equal(got, jreg.region_dissolve(lab, **kw))
    assert not np.isin(labels, got).any()
    with pytest.raises(ValueError):
        treg.region_dissolve(lab)


@pytest.mark.parametrize("latlon", [False, True])
@pytest.mark.parametrize("variant", ["plain", "mask", "friction"])
def test_spread2d_bitwise(latlon, variant):
    rng = np.random.RandomState(6)
    obs = np.zeros((30, 41))
    obs.ravel()[rng.choice(obs.size, 12, replace=False)] = rng.randint(1, 9, 12)
    kw = dict(nodata=0, latlon=latlon, transform=_LATLON if latlon else _PROJ)
    if variant == "mask":
        msk = np.ones(obs.shape, bool)
        msk[:, 20] = False
        kw.update(msk=msk)
    elif variant == "friction":
        kw.update(frc=rng.rand(*obs.shape) + 0.5)
    got = pyflwdir_torch.spread2d(obs, **kw)
    want = jgt.spread2d(obs, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(trt.spread2d(obs, **kw)[1], jrt.spread2d(obs, **kw)[1])


def test_get_edge_and_gis_names():
    mask = np.zeros((9, 11), bool)
    mask[2:7, 3:9] = True
    assert np.array_equal(tgt.get_edge(mask), np.asarray(jgt.get_edge(mask)))
    assert set(tgis.__all__) == set(jgis.__all__)
    for name in tgis.__all__:
        assert getattr(tgis, name) is not None


def test_features_bitwise(rasters):
    _, j, t = rasters
    paths = [np.array([0, 1, 2]), np.array([5]), np.array([7, 7]), np.array([3, 4])]
    upa = t.upstream_area()
    assert (tgt.features(paths, transform=t.transform, shape=t.shape, upa=upa)
            == jgt.features(paths, transform=j.transform, shape=j.shape, upa=upa))
    xs, ys = t.xy(np.arange(t.size))
    assert tgt.features(paths, xs=xs, ys=ys) == jgt.features(paths, xs=xs, ys=ys)
    with pytest.raises(ValueError):
        tgt.features(paths)
    with pytest.raises(ValueError):
        tgt.features(paths, transform=t.transform, shape=t.shape, upa=upa.ravel()[:3])


def test_vectorize_streams_bitwise(rasters):
    _, j, t = rasters
    assert t.vectorize() == j.vectorize()
    assert t.vectorize(direction="up") == j.vectorize(direction="up")
    strord = t.stream_order()
    for kw in (dict(), dict(min_sto=2), dict(strord=strord), dict(max_len=5),
               dict(mask=t.upstream_area() >= 10)):
        assert t.streams(**kw) == j.streams(**kw)
    for direction in ("up", "down"):
        got = t.streams(idxs_out=t.idxs_pit, direction=direction)
        assert got == j.streams(idxs_out=j.idxs_pit, direction=direction)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_cross_load(rasters, tmp_path, writer):
    _, j, t = rasters
    upa = t.upstream_area()
    path = str(tmp_path / f"ck_{writer}")
    tile = (5, 7)
    save = tck.save_sharded if writer == "torch" else jck.save_sharded
    save(t if writer == "torch" else j, path, tile=tile, rasters={"upa": upa})
    tl, textra = tck.load_sharded(path, rasters=("upa",), device="cpu")
    jl, jextra = jck.load_sharded(path, rasters=("upa",))
    for got in (tl, jl):
        assert np.array_equal(got.idxs_ds, t.idxs_ds)
        assert got.shape == t.shape and got.ftype == t.ftype and got.latlon == t.latlon
        assert tuple(got.transform) == tuple(t.transform)
    assert tl.device.type == "cpu" and tl.idxs_ds.dtype == np.int64
    assert np.array_equal(textra["upa"], upa) and np.array_equal(jextra["upa"], upa)
    assert np.array_equal(tl.upstream_area(), upa)
    # one window of tiles, as a shard would load it
    with open(f"{path}/manifest.json") as f:
        import json

        meta = json.load(f)["rasters"]["upa"]
    win = tck.load_raster(path, "upa", meta, tile_slice=(1, 2, 0, 2))
    assert np.array_equal(win, upa[5:10, :14])
    assert np.array_equal(win, jck.load_raster(path, "upa", meta, tile_slice=(1, 2, 0, 2)))
