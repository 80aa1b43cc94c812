"""Moving windows, upstream sums, ``downstream`` and ``lstsq``: the port's
``arithmetics.py`` and the objects' methods against the JAX package's, on
the CPU.

Medians bitwise, windows with an even count of valid values among them
(the midpoint rule of ``jnp.nanmedian``; ``torch.nanmedian`` would take the
lower value). Averages bitwise: the port sums the window's rows in order
in the types the JAX expression takes. Integer upstream sums bitwise; float
ones within rtol 8 eps of the dtype (at most 8 upstream terms, added in
another order). Nodata as -9999 and as NaN. Grids: the 15x12 ``d8_small``
and the 128x192 grid of ``test_torch_order``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import arithmetics as tar
from pyflwdir_torch.ops import walk as twalk
from pyflwdir_tpu import arithmetics as jar
from tests.test_torch_order import _grid


@pytest.fixture(scope="module", params=["d8_small", "128x192"])
def rasters(request, d8_small):
    d8 = d8_small if request.param == "d8_small" else _grid((128, 192))
    j = pyflwdir_tpu.from_array(d8)
    t = pyflwdir_torch.from_array(d8, device="cpu")
    return d8, j, t


def _data(shape, nodata, dtype=np.float32, seed=11, frac=0.2):
    rng = np.random.RandomState(seed)
    data = (rng.rand(*shape) * 100).astype(dtype)
    data[rng.rand(*shape) < frac] = nodata
    return data


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("nodata", [-9999.0, np.nan])
@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("restrict", [False, True])
def test_moving_median_bitwise(rasters, nodata, n, restrict):
    _, j, t = rasters
    data = _data(t.shape, nodata)
    want = j.moving_median(data, n, restrict_strord=restrict, nodata=nodata)
    got = t.moving_median(data, n, restrict_strord=restrict, nodata=nodata)
    _same(got, want)
    # the windows hold even counts of valid values, where the midpoint and
    # the lower middle value part
    win = twalk.window_indices(t._ds, torch.as_tensor(t.idxs_us_main), n,
                               torch.as_tensor(t.stream_order().ravel()) if restrict else None)
    win = win.numpy()
    vals = data.ravel()[np.maximum(win, 0)]
    ok = (win >= 0) & ~(np.isnan(vals) if np.isnan(nodata) else vals == nodata)
    even = (ok.sum(axis=0) % 2 == 0) & ok[n]
    assert even.any()
    lower = torch.nanmedian(torch.as_tensor(np.where(ok, vals, np.nan)), dim=0).values.numpy()
    assert np.any(lower[even] != got.ravel()[even])


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_moving_median_dtypes(rasters, dtype):
    _, j, t = rasters
    data = _data(t.shape, -9999, dtype=dtype)
    _same(t.moving_median(data, 3), j.moving_median(data, 3))


@pytest.mark.parametrize("nodata", [-9999.0, np.nan])
@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("restrict", [False, True])
def test_moving_average_bitwise(rasters, nodata, n, restrict):
    _, j, t = rasters
    data = _data(t.shape, nodata)
    want = j.moving_average(data, n, restrict_strord=restrict, nodata=nodata)
    got = t.moving_average(data, n, restrict_strord=restrict, nodata=nodata)
    _same(got, want)


@pytest.mark.parametrize("dtype, wdtype", [(np.float32, np.float32), (np.float32, np.float64),
                                           (np.float64, np.float32), (np.int32, None),
                                           (np.int32, np.float32)])
def test_moving_average_types_and_weights(rasters, dtype, wdtype):
    _, j, t = rasters
    data = _data(t.shape, -9999, dtype=dtype, frac=0.1)
    weights = None
    if wdtype is not None:
        weights = np.random.RandomState(8).rand(*t.shape).astype(wdtype)
        weights.ravel()[::7] = 0  # cells whose window may hold no weight
    want = j.moving_average(data, 2, weights=weights)
    got = t.moving_average(data, 2, weights=weights)
    _same(got, want)


def test_moving_average_closed_form(rasters):
    """The float64 average of the window, by a numpy oracle of the walk's
    rule, within 2 (2n+1) eps64 of the sum of the magnitudes."""
    _, _, t = rasters
    n = 4
    data = _data(t.shape, -9999.0, dtype=np.float64)
    got = t.moving_average(data, n).ravel()
    win = twalk.window_indices(t._ds, torch.as_tensor(t.idxs_us_main), n).numpy()
    vals = data.ravel()[np.maximum(win, 0)]
    ok = (win >= 0) & (vals != -9999.0)
    num = np.where(ok, vals, 0).sum(axis=0)
    cnt = ok.sum(axis=0)
    centre = data.ravel() != -9999.0
    want = num[centre] / cnt[centre]
    tol = 2 * (2 * n + 1) * np.finfo(np.float64).eps * np.abs(np.where(ok, vals, 0)).sum(0)
    assert np.all(np.abs(got[centre] - want) <= tol[centre] / cnt[centre])
    assert np.all(got[~centre] == -9999.0)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_upstream_sum_int_bitwise(rasters, dtype):
    _, j, t = rasters
    data = _data(t.shape, -9999, dtype=dtype, frac=0.05)
    _same(t.upstream_sum(data), j.upstream_sum(data))
    # and against np.add.at on the cells that send
    ids, ar = t.idxs_ds, np.arange(t.size)
    d = data.ravel()
    send = (ids >= 0) & (ids != ar) & (d != -9999)
    send &= d[np.where(ids >= 0, ids, ar)] != -9999
    want = np.zeros(t.size, dtype)
    np.add.at(want, ids[send], d[send])
    got = t.upstream_sum(data).ravel()
    keep = got != -9999
    assert np.array_equal(got[keep], want[keep])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_upstream_sum_float(rasters, dtype):
    _, j, t = rasters
    data = _data(t.shape, -9999.0, dtype=dtype, frac=0.05)
    want = j.upstream_sum(data)
    got = t.upstream_sum(data)
    assert got.dtype == want.dtype
    assert np.array_equal(got == -9999.0, want == -9999.0)
    eps = np.finfo(dtype).eps
    assert np.allclose(got, want, rtol=8 * eps, atol=0)
    # a second call, the same bits
    assert np.array_equal(t.upstream_sum(data), got)


def test_downstream_bitwise(rasters):
    _, j, t = rasters
    for dtype in (np.float32, np.int32):
        data = _data(t.shape, -9999, dtype=dtype)
        _same(t.downstream(data), j.downstream(data))


def test_graph_object_moving_windows():
    d8 = _grid((64, 96))
    j = pyflwdir_tpu.Flwdir(pyflwdir_tpu.from_array(d8).idxs_ds)
    t = pyflwdir_torch.Flwdir(pyflwdir_torch.from_array(d8, device="cpu").idxs_ds,
                              device="cpu")
    data = _data((d8.size,), -9999.0)
    _same(t.moving_median(data, 3), j.moving_median(data, 3))
    _same(t.moving_average(data, 3), j.moving_average(data, 3))
    _same(t.upstream_sum(data.astype(np.int32)), j.upstream_sum(data.astype(np.int32)))


def test_module_functions_bitwise(rasters):
    _, j, t = rasters
    data = _data(t.shape, -9999.0).ravel()
    jd, td = jnp.asarray(data), torch.as_tensor(data)
    jus, tus = jnp.asarray(j.idxs_us_main), torch.as_tensor(t.idxs_us_main)
    jds = jnp.asarray(j.idxs_ds)
    for name in ("moving_median", "moving_average"):
        kw = dict(weights=None) if name == "moving_average" else {}
        want = np.asarray(getattr(jar, name)(data=jd, n=2, idxs_ds=jds, idxs_us_main=jus, **kw))
        got = getattr(tar, name)(data=td, n=2, idxs_ds=t._ds, idxs_us_main=tus, **kw).numpy()
        _same(got, want)


def test_lstsq():
    rng = np.random.RandomState(1)
    x = rng.rand(5, 9)
    y = 3.0 * x - 2.0 + rng.rand(5, 9) * 1e-3
    ws, wi = jar.lstsq(x, y)
    gs, gi = tar.lstsq(x, y, device="cpu")
    assert gs.dtype == gi.dtype == torch.float64
    assert np.allclose(gs.numpy(), np.asarray(ws), rtol=1e-12, atol=0)
    assert np.allclose(gi.numpy(), np.asarray(wi), rtol=1e-12, atol=1e-13)
    assert np.allclose(gs.numpy(), 3.0, atol=1e-2)
    ts, _ = tar.lstsq(torch.as_tensor(x), torch.as_tensor(y))  # on the tensors' device
    assert torch.equal(ts, gs)
