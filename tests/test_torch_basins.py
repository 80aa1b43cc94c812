"""Sub-basins, the interbasin mask, inflow and outflow cells, river-length
smoothing and stream segments: the port's ``basins.py``, ``streams.py`` and
``FlwdirRaster`` methods against the JAX package's, on the CPU. Labels,
outlets, masks and indices bitwise; river lengths and segments exactly
(the same native sweeps on the same inputs). Grids: the 15x12
``d8_small`` and a 128x192 grid from a seeded DEM with missing cells."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import basins as tbasins
from pyflwdir_torch import streams as tstreams
from pyflwdir_tpu import streams as jstreams
from tests.test_torch_order import _grid


@pytest.fixture(scope="module", params=["d8_small", "128x192"])
def rasters(request, d8_small):
    d8 = d8_small if request.param == "d8_small" else _grid((128, 192))
    j = pyflwdir_tpu.from_array(d8)
    t = pyflwdir_torch.from_array(d8, device="cpu")
    return d8, j, t


def _region(shape):
    region = np.zeros(shape, dtype=bool)
    region[shape[0] // 2:, : shape[1] // 2] = True
    return region


def test_subbasins_streamorder(rasters):
    _, j, t = rasters
    got, out = t.subbasins_streamorder()
    want, jout = j.subbasins_streamorder()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(out, jout)
    # each outlet labels its own basin, and basins are closed
    assert got.max() == out.size
    assert np.all(got.ravel()[out] == np.arange(1, out.size + 1))
    sb, ids = got.ravel(), t.idxs_ds
    inner = (sb > 0) & ~np.isin(np.arange(t.size), out)
    assert np.all(sb[ids[inner]] == sb[inner])
    mask = t.upstream_area() > 3
    got, out = t.subbasins_streamorder(min_sto=2, mask=mask)
    want, jout = j.subbasins_streamorder(min_sto=2, mask=mask)
    assert np.array_equal(got, want) and np.array_equal(out, jout)


@pytest.mark.parametrize("depth", [1, 2])
def test_subbasins_pfafstetter(rasters, depth):
    _, j, t = rasters
    got, out = t.subbasins_pfafstetter(depth=depth)
    want, jout = j.subbasins_pfafstetter(depth=depth)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(out, jout)
    valid = t.rank.ravel() >= 0
    assert np.all(got.ravel()[valid] >= 1) and got.max() < 10**depth
    got, out = t.subbasins_pfafstetter(depth=depth, upa_min=5)
    want, jout = j.subbasins_pfafstetter(depth=depth, upa_min=5)
    assert np.array_equal(got, want) and np.array_equal(out, jout)


@pytest.mark.parametrize("area_min", [5, 50])
def test_subbasins_area(rasters, area_min):
    _, j, t = rasters
    upa = t.upstream_area()
    got, out = t.subbasins_area(area_min, uparea=upa)
    want, jout = j.subbasins_area(area_min, uparea=upa)
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want) and np.array_equal(out, jout)
    assert out.size >= t.idxs_pit.size
    assert int((got > 0).sum()) == t.nnodes  # every valid cell in a sub-basin
    # uparea derived in km2
    got, out = t.subbasins_area(1e-6 * area_min)
    want, jout = j.subbasins_area(1e-6 * area_min)
    assert np.array_equal(got, want) and np.array_equal(out, jout)


@pytest.mark.parametrize("with_stream", [False, True])
def test_interbasin_mask(rasters, with_stream):
    _, j, t = rasters
    region = _region(t.shape)
    stream = (t.upstream_area() >= 10) if with_stream else None
    got = t.interbasin_mask(region, stream=stream)
    want = j.interbasin_mask(region, stream=stream)
    assert got.dtype == want.dtype == bool
    assert np.array_equal(got, want)
    assert not np.any(got & ~region)


def test_inflow_outflow(rasters):
    _, j, t = rasters
    region = _region(t.shape)
    got_in, got_out = t.inflow_idxs(region), t.outflow_idxs(region)
    assert np.array_equal(got_in, j.inflow_idxs(region))
    assert np.array_equal(got_out, j.outflow_idxs(region))
    rgn, ids = region.ravel(), t.idxs_ds
    assert got_out.size > 0 and np.all(rgn[got_out])
    assert np.all((ids[got_out] == got_out) | ~rgn[ids[got_out]])
    assert np.all(~rgn[got_in] & rgn[ids[got_in]])


def test_smooth_rivlen(rasters):
    _, j, t = rasters
    rivlen = np.random.RandomState(21).rand(*t.shape) * 3
    rivlen[0, :3] = -9999.0
    got = t.smooth_rivlen(rivlen, 1.0, max_window=6)
    want = j.smooth_rivlen(rivlen, 1.0, max_window=6)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not np.array_equal(got, rivlen)


@pytest.mark.parametrize("max_len", [0, 5])
def test_streams(rasters, max_len):
    _, j, t = rasters
    rank, nup = t.rank.ravel(), t.n_upstream.ravel()
    mask = t.upstream_area().ravel() >= 4
    got = tstreams.streams(t.idxs_ds, rank, nup, mask=mask, max_len=max_len)
    want = jstreams.streams(j.idxs_ds, rank, nup, mask=mask, max_len=max_len)
    assert len(got) == len(want) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_stream_functions(rasters):
    _, j, t = rasters
    rng = np.random.RandomState(22)
    area = rng.rand(t.size)
    ds = torch.as_tensor(t.idxs_ds)
    jds = jnp.asarray(j.idxs_ds)
    got = tstreams.upstream_area(ds, torch.as_tensor(area)).numpy()
    want = np.asarray(jstreams.upstream_area(jds, jnp.asarray(area)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * area.sum())
    data = rng.randint(0, 5, t.size).astype(np.int32)
    data[rng.rand(t.size) < 0.1] = -9999
    tree = t.rank.ravel() >= 0
    got = tstreams.accuflux(ds, torch.as_tensor(data), tree=torch.as_tensor(tree)).numpy()
    want = np.asarray(jstreams.accuflux(jds, jnp.asarray(data), tree=jnp.asarray(tree)))
    assert np.array_equal(got, want)
    got = tstreams.stream_order(ds, torch.as_tensor(t.idxs_us_main)).numpy()
    assert np.array_equal(got, t.stream_order("classic").ravel())
    basins = tbasins.basins(ds, t.idxs_pit)
    assert np.array_equal(t._check_data(None, "basins"), basins)
    assert np.array_equal(t._check_data(None, "strord", flatten=False), t.stream_order())
    with pytest.raises(ValueError, match="shape does not match"):
        t._check_data(np.ones(3), "x", flatten=False)
