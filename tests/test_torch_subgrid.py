"""Unit catchments and sub-grid rivers: the port's ``subgrid.py`` and the
``FlwdirRaster`` methods built on it (``ucat_*``, ``subgrid_*``,
``streams(idxs_out=...)``) against the JAX package's, on the CPU.

Outlets, label maps, areas in cells and every host statistic (segment
lengths, means, medians, slopes, indices, fixed-length slopes) are
bitwise: the walks are the shared native library's and the reductions the
same numpy calls. The float sums of ``ucat_area(unit="km2")`` and
``ucat_volume`` add in another order than the JAX scatter-add: per
outlet |port - JAX| <= (k - 1) eps sum|term|, k the catchment's cell
count, eps that of the sum's dtype; two calls give the same bits."""

import numpy as np
import pytest
import torch

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import subgrid as tsg
from pyflwdir_tpu import subgrid as jsg
from tests.test_torch_order import _grid

CPU = torch.device("cpu")
_LATLON = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)
_PROJ = (30.0, 0.0, 400000.0, 0.0, -25.0, 5800000.0)


@pytest.fixture(scope="module", params=["d8_small-latlon", "160x200-latlon", "128x192-proj"])
def grid(request, d8_small):
    name, tf = request.param.split("-")
    d8 = {"d8_small": d8_small, "160x200": _grid((160, 200)),
          "128x192": _grid((128, 192))}[name]
    tf, latlon = (_LATLON, True) if tf == "latlon" else (_PROJ, False)
    t = pyflwdir_torch.from_array(d8, transform=tf, latlon=latlon, device="cpu")
    j = pyflwdir_tpu.from_array(d8, transform=pyflwdir_tpu.Affine(*tf), latlon=latlon)
    cs = 3 if name == "d8_small" else 10
    out = t.ucat_outlets(cs)
    assert np.array_equal(out, j.ucat_outlets(cs))
    rng = np.random.RandomState(11)
    return t, j, out, rng


def _within_rule(got, want, labels, terms, eps, m):
    """Per outlet: |got - want| <= (k - 1) eps sum|term|."""
    k = np.bincount(labels[labels > 0] - 1, minlength=m)
    tot = np.bincount(labels[labels > 0] - 1, weights=np.abs(terms[labels > 0]), minlength=m)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err <= np.maximum(k - 1, 0) * eps * tot)


@pytest.mark.parametrize("method", ["dmm", "eam_plus"])
@pytest.mark.parametrize("cellsize", [3, 5, 10])
def test_outlets_bitwise(grid, method, cellsize):
    t, j, _, _ = grid
    upa = t.upstream_area().ravel()
    got = tsg.outlets(t.idxs_ds, upa, cellsize, t.shape, method=method, device=CPU)
    want = jsg.outlets(j.idxs_ds, upa, cellsize, j.shape, method=method)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    assert np.array_equal(t.ucat_outlets(cellsize, method=method).ravel(), got[0])
    with pytest.raises(ValueError, match="Unknown method"):
        t.ucat_outlets(cellsize, method="ihu")
    with pytest.raises(ValueError, match="unknown"):
        tsg.outlets(t.idxs_ds, upa, cellsize, t.shape, method="ihu", device=CPU)


def test_ucat_area_cells_bitwise(grid):
    t, j, out, _ = grid
    mt, at = t.ucat_area(out, unit="cell")
    mj, aj = j.ucat_area(out, unit="cell")
    assert np.array_equal(mt, mj) and at.dtype == aj.dtype == np.int32
    assert np.array_equal(at, aj)
    has = out.ravel() != -1
    assert at.ravel()[has].sum() == (mt > 0).sum() and np.all(at.ravel()[~has] == -9999)
    # module level, outlets with a missing one
    out2 = out.ravel().copy()
    out2[0] = -1
    m2, a2 = tsg.ucat_area(out2, t.idxs_ds, torch.ones(t.size, dtype=torch.int32), device=CPU)
    import jax.numpy as jnp

    mj2, aj2 = jsg.ucat_area(out2, jnp.asarray(j.idxs_ds), jnp.ones(j.size, dtype=jnp.int32))
    assert np.array_equal(m2.numpy(), np.asarray(mj2)) and np.array_equal(a2.numpy(),
                                                                          np.asarray(aj2))
    with pytest.raises(ValueError, match="Unknown unit"):
        t.ucat_area(out, unit="acre")


@pytest.mark.parametrize("unit", ["km2", "m2", "ha"])
def test_ucat_area_float_rule(grid, unit):
    t, j, out, _ = grid
    mt, at = t.ucat_area(out, unit=unit)
    mj, aj = j.ucat_area(out, unit=unit)
    # the cell areas' dtype: float64 on a latlon grid, float32 on a projected one
    assert np.array_equal(mt, mj) and at.dtype == aj.dtype == np.asarray(t.area).dtype
    at2 = t.ucat_area(out, unit=unit)[1]
    assert np.array_equal(at, at2)
    factor = {"km2": 1e6, "m2": 1.0, "ha": 1e4}[unit]
    terms = np.asarray(t.area).ravel() / factor
    _within_rule(at.ravel(), aj.ravel(), mt.ravel(), terms, np.finfo(at.dtype).eps, out.size)
    assert np.array_equal(at.ravel() == -9999, out.ravel() == -1)


@pytest.mark.parametrize("depths", [None, np.array([0.25, 1.0, 4.0], np.float64)])
def test_ucat_volume_rule(grid, depths):
    t, j, out, rng = grid
    elev = rng.rand(*t.shape) * 5
    hand = t.hand(t.upstream_area() >= 8, elev)
    kw = {} if depths is None else dict(depths=depths)
    mt, vt = t.ucat_volume(out, hand, **kw)
    mj, vj = j.ucat_volume(out, hand, **kw)
    ds = np.arange(0.5, 3.0, 0.5, dtype=np.float32) if depths is None else depths
    assert np.array_equal(mt, mj) and vt.dtype == vj.dtype == ds.dtype
    assert vt.shape == vj.shape == (ds.size, *out.shape)
    vt2 = t.ucat_volume(out, hand, **kw)[1]
    assert np.array_equal(vt, vt2)
    area = np.asarray(t.area).ravel()
    h = hand.ravel()
    for i, d in enumerate(ds):
        terms = (area * np.maximum(0.0, d - h)).astype(np.float32)
        _within_rule(vt[i].ravel(), vj[i].ravel(), mt.ravel(), terms,
                     np.finfo(np.float32).eps, out.size)
    assert np.all(np.diff(vt.reshape(ds.size, -1)[:, out.ravel() != -1], axis=0) >= 0)


def _data(rng, n, nodata, dtype=np.float32):
    x = (rng.rand(n) * 100).astype(dtype)
    x[rng.rand(n) < 0.1] = nodata
    return x


@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("masked", [False, True])
def test_segments_bitwise(grid, direction, masked):
    t, j, out, rng = grid
    out = out.ravel()
    nxt = t.idxs_us_main if direction == "up" else t.idxs_ds
    assert np.array_equal(nxt, j.idxs_us_main if direction == "up" else j.idxs_ds)
    mask = (t.upstream_area().ravel() >= 3) if masked else None
    n = t.size
    distnc = t.distnc.ravel()
    for dist in (distnc, t.stream_distance().ravel()):
        assert np.array_equal(tsg.segment_length(out, nxt, dist, mask=mask),
                              jsg.segment_length(out, nxt, dist, mask=mask))
    w = rng.rand(n).astype(np.float32)
    for nodata in (-9999.0, np.nan):
        data = _data(rng, n, nodata)
        for fn, args in (("segment_average", (data, w)), ("segment_median", (data, w))):
            got = getattr(tsg, fn)(out, nxt, *args, mask=mask, nodata=nodata)
            want = getattr(jsg, fn)(out, nxt, *args, mask=mask, nodata=nodata)
            assert np.array_equal(got, want, equal_nan=True), fn
    elev = rng.rand(n) * 50
    for lstsq in (True, False):
        assert np.array_equal(
            tsg.segment_slope(out, nxt, elev, distnc, mask=mask, lstsq=lstsq),
            jsg.segment_slope(out, nxt, elev, distnc, mask=mask, lstsq=lstsq), equal_nan=True)
    for max_len in (0, 3):
        got = tsg.segment_indices(out, nxt, mask=mask, max_len=max_len)
        want = jsg.segment_indices(out, nxt, mask=mask, max_len=max_len)
        assert len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("lstsq", [True, False])
def test_fixed_length_slope_bitwise(grid, lstsq):
    t, j, out, rng = grid
    elev = rng.rand(t.size) * 50
    distnc = t.distnc.ravel()
    for length, mask in ((1000.0, None), (3000.0, t.upstream_area().ravel() >= 3)):
        got = tsg.fixed_length_slope(out.ravel(), t.idxs_ds, t.idxs_us_main, elev, distnc,
                                     length=length, mask=mask, lstsq=lstsq)
        want = jsg.fixed_length_slope(out.ravel(), j.idxs_ds, j.idxs_us_main, elev, distnc,
                                      length=length, mask=mask, lstsq=lstsq)
        assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("direction", ["up", "down"])
def test_subgrid_methods_bitwise(grid, direction):
    t, j, out, rng = grid
    assert np.array_equal(t.distnc, j.distnc)
    for unit in ("cell", "m"):
        got = t.subgrid_rivlen(out, direction=direction, unit=unit)
        assert got.shape == out.shape
        assert np.array_equal(got, j.subgrid_rivlen(out, direction=direction, unit=unit))
    elev = rng.rand(*t.shape) * 50
    for method in ("mean", "lstsq"):
        for d in (direction, "both"):
            assert np.array_equal(t.subgrid_rivslp(out, elev, direction=d, method=method),
                                  j.subgrid_rivslp(out, elev, direction=d, method=method))
    data = _data(rng, t.size, -9999.0).reshape(t.shape)
    w = rng.rand(*t.shape)
    for fn in ("subgrid_rivavg", "subgrid_rivmed"):
        for kw in (dict(), dict(weights=w), dict(mask=t.upstream_area() >= 3)):
            assert np.array_equal(getattr(t, fn)(out, data, direction=direction, **kw),
                                  getattr(j, fn)(out, data, direction=direction, **kw)), fn
    # every cell an outlet (idxs_out=None)
    assert np.array_equal(t.subgrid_rivlen(None, direction=direction),
                          j.subgrid_rivlen(None, direction=direction))
    with pytest.raises(ValueError, match="flow direction"):
        t.subgrid_rivlen(out, direction="both")
    with pytest.raises(ValueError, match="Unknown unit"):
        t.subgrid_rivlen(out, unit="km")


@pytest.mark.parametrize("direction", ["up", "down"])
def test_streams_idxs_out_bitwise(grid, direction):
    t, j, out, _ = grid
    for kw in (dict(), dict(max_len=3), dict(min_sto=2), dict(mask=t.upstream_area() >= 3)):
        got = t.streams(idxs_out=out, direction=direction, **kw)
        assert len(got) > 0 and got == j.streams(idxs_out=out, direction=direction, **kw)
