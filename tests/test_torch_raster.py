"""The port's first slice end to end against the JAX package: D8 raster ->
from_array -> upstream_area / accuflux / rank, on the CPU."""

import numpy as np
import pytest
import torch

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import dem as tdem
from pyflwdir_torch.utils.affine import Affine

# Float accumulations are float64 in both packages, but the prefix sums run
# in different orders; an interval difference keeps an absolute error of a
# few ulps of the running total, hence the absolute term 1e-14 * total.


def _demo_d8(shape, seed=7):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    return tdem.fill_depressions(z)[1]


_LATLON = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)


@pytest.fixture(scope="module", params=["small", "256x384"])
def rasters(request, d8_small):
    d8 = d8_small if request.param == "small" else _demo_d8((256, 384))
    j = pyflwdir_tpu.from_array(d8, transform=_LATLON, latlon=True)
    t = pyflwdir_torch.from_array(d8, transform=_LATLON, latlon=True, device="cpu")
    return d8, j, t


def test_graph_equal(rasters):
    _, j, t = rasters
    assert t.idxs_ds.dtype == np.int64
    assert np.array_equal(t.idxs_ds, j.idxs_ds)
    assert np.array_equal(t.idxs_pit, j.idxs_pit)
    assert np.array_equal(t.idxs_outlet, j.idxs_outlet)
    assert t.shape == j.shape and t.ftype == j.ftype
    assert np.array_equal(t.mask, j.mask)
    assert isinstance(t.transform, Affine) and tuple(t.transform) == tuple(j.transform)


def test_upstream_area_cells_bitwise(rasters):
    _, j, t = rasters
    want = j.upstream_area()
    got = t.upstream_area()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    # mass conservation: pit sums equal the valid count
    assert got.ravel()[t.idxs_pit].sum() == int(t.mask.sum())


@pytest.mark.parametrize("unit", ["km2", "m2", "ha"])
def test_upstream_area_units_close(rasters, unit):
    _, j, t = rasters
    want = j.upstream_area(unit)
    got = t.upstream_area(unit)
    assert got.dtype == want.dtype == np.float64
    total = want.ravel()[t.idxs_pit].sum()  # the prefix sum's final value
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14 * total)


def test_area_equal(rasters):
    _, j, t = rasters
    assert np.array_equal(t.area, j.area)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64])
def test_accuflux(rasters, dtype):
    _, j, t = rasters
    rng = np.random.RandomState(8)
    data = (rng.rand(*t.shape) * 10).astype(dtype)
    want = j.accuflux(data)
    got = t.accuflux(data)
    assert got.dtype == want.dtype
    if np.issubdtype(dtype, np.integer):
        assert np.array_equal(got, want)
    else:
        # float32 results are float64 sums rounded once: 1 ulp of float32
        rtol = 1e-12 if dtype == np.float64 else 1.2e-7
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-14 * data.sum())


def test_rank_and_nnodes(rasters):
    _, j, t = rasters
    assert np.array_equal(t.rank, j.rank)
    assert t.rank.shape == j.rank.shape
    assert t.nnodes == j.nnodes


@pytest.mark.parametrize("scale", [1, 2**24])
def test_integer_guard_picks_the_same_engine(rasters, monkeypatch, scale):
    _, j, t = rasters
    import pyflwdir_torch.ops.plan as tplan
    import pyflwdir_tpu.ops.plan as jplan

    calls = {"jax": 0, "torch": 0}

    def spy(mod, key):
        real = mod.accumulate_planned

        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(mod, "accumulate_planned", wrapped)

    spy(jplan, "jax")
    spy(tplan, "torch")
    data = np.full(t.shape, scale, dtype=np.int64)
    got = t.accuflux(data)
    want = j.accuflux(data)
    assert np.array_equal(got, want)
    assert calls["torch"] == calls["jax"] == (1 if scale > 1 else 0)


def test_no_gpu_and_no_device_raises(d8_small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pyflwdir_torch.from_array(d8_small)


def test_later_slices_raise(d8_small):
    t = pyflwdir_torch.from_array(d8_small, device="cpu")
    data = np.ones(t.shape, np.float32)
    data[3, 3] = -9999
    with pytest.raises(NotImplementedError, match="later slice"):
        t.accuflux(data)
    with pytest.raises(NotImplementedError, match="later slice"):
        t.fillnodata(np.ones(t.shape), -9999, direction="down")
    with pytest.raises(NotImplementedError, match="later slice"):
        t.basins(idxs=[3], streams=np.ones(t.shape, bool))
    with pytest.raises(ValueError):
        t.accuflux(np.ones(t.shape), direction="sideways")
    big = pyflwdir_torch.from_array(np.zeros((2049, 1024), np.uint8), device="cpu")
    with pytest.raises(NotImplementedError, match="tile plan"):
        big.upstream_area()


def test_sequential_oracle(rasters):
    _, _, t = rasters
    from pyflwdir_torch.runtime import accuflux_sweep

    rnk = t.rank.ravel()
    seq = np.argsort(np.where(rnk >= 0, rnk, -1), kind="stable")
    seq = seq[rnk[seq] >= 0]
    want = accuflux_sweep(t.idxs_ds, seq, np.ones(t.size))
    got = t.upstream_area().ravel()
    assert np.array_equal(got[t.mask], want[t.mask].astype(np.int32))
