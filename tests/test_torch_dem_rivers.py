"""The rest of ``dem`` and ``rivers``: the port's ``slope``,
``floodplains``, ``adjust_elevation``, ``dig_4connectivity``,
``classify_estuary`` and ``rivdph_gvf`` and the object methods on them
(``floodplains``, ``dem_dig_d4``, ``dem_adjust``, ``classify_estuaries``,
``river_depth``) against the JAX package's, on the CPU.

The slope is bitwise: the stencil in the input's float type, the divisor
a tensor, and ``jnp.hypot``'s formula with ``1 + r^2`` rounded once, as
XLA's CPU code contracts it into a fused multiply-add. The floodplain map
is bitwise but where a cell's margin lies within an ulp of its threshold
``uparea ** b`` (float32 ``pow`` of XLA and of PyTorch may differ there);
the test counts such cells. The estuary map is bitwise; the host results
(elevation adjustment, D4 digging, Manning and GVF depths) are the JAX
package's bits."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import dem as tdem
from pyflwdir_torch import rivers as trv
from pyflwdir_torch.ops import graph as tgraph
from pyflwdir_tpu import dem as jdem
from pyflwdir_tpu import rivers as jrv
from tests.test_torch_order import _grid

CPU = torch.device("cpu")
_LATLON = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)
_PROJ = (30.0, 0.0, 400000.0, 0.0, -25.0, 5800000.0)


@pytest.fixture(scope="module", params=["d8_small", "160x200", "128x192"])
def grid(request, d8_small):
    d8 = {"d8_small": d8_small, "160x200": _grid((160, 200)),
          "128x192": _grid((128, 192))}[request.param]
    t = pyflwdir_torch.from_array(d8, transform=_LATLON, latlon=True, device="cpu")
    j = pyflwdir_tpu.from_array(d8, transform=pyflwdir_tpu.Affine(*_LATLON), latlon=True)
    rng = np.random.RandomState(5)
    # elevation rising upstream, with noise: floodplains of some width
    elev = np.where(t.rank >= 0, t.rank * 0.4, 0.0) + rng.rand(*t.shape)
    return t, j, elev, rng


@pytest.mark.parametrize("transform", [_LATLON, _PROJ])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nodata", [-9999.0, np.nan])
def test_slope_bitwise(transform, dtype, nodata):
    rng = np.random.RandomState(3)
    z = (rng.rand(60, 70) * 300 + np.add.outer(np.arange(60.0), np.arange(70.0))).astype(dtype)
    z[rng.rand(60, 70) < 0.05] = nodata
    z[0, :5] = nodata
    latlon = transform is _LATLON
    got = pyflwdir_torch.slope(z, nodata=nodata, latlon=latlon, transform=transform, device=CPU)
    want = np.asarray(pyflwdir_tpu.slope(z, nodata=nodata, latlon=latlon,
                                         transform=pyflwdir_tpu.Affine(*transform)))
    assert got.dtype == torch.float32 and got.shape == z.shape
    assert np.array_equal(got.numpy(), want, equal_nan=True)


def test_slope_planes():
    flat = np.ones((6, 8), dtype=np.float32)
    assert np.array_equal(tdem.slope(flat, device=CPU).numpy(), np.zeros((6, 8), np.float32))
    plane = np.tile(np.arange(8, dtype=np.float32) * 0.5, (6, 1))
    got = tdem.slope(plane, device=CPU).numpy()
    assert np.array_equal(got, np.asarray(jdem.slope(plane)))
    assert np.allclose(got[1:-1, 1:-1], 0.5, atol=1e-6)


def test_hypot_edges():
    """Zeros, infinities, NaN and tiny ratios as ``jnp.hypot`` gives them."""
    for dt in (np.float32, np.float64):
        x = np.array([0, 0, 3, np.inf, -np.inf, np.nan, 1e-30, 5, 1], dt)
        y = np.array([0, -2, 4, 1, np.nan, 1, 1, -1e-20, 1], dt)
        got = tdem._hypot(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        assert np.array_equal(got, np.asarray(jnp.hypot(x, y)), equal_nan=True)


def _flood_args(t, elev, upa_min, b):
    upa = t.upstream_area("km2").ravel()
    ds = t._ds
    stream = torch.as_tensor((upa >= upa_min) & (t.idxs_ds >= 0))
    tt = tgraph.reach(ds, stream)
    z = torch.as_tensor(elev.ravel(), dtype=torch.float32)
    pathmax = tgraph.path_reduce(ds, z, stop=stream, op="max")
    margin = (pathmax - z[tt]).numpy()
    with np.errstate(invalid="ignore"):  # -9999 at missing cells
        thresh = torch.as_tensor(upa, dtype=torch.float32)[tt].numpy() ** np.float32(b)
    return upa, margin, thresh


@pytest.mark.parametrize("upa_min,b", [(5.0, 0.3), (20.0, 0.3), (5.0, 0.0)])
def test_floodplains_bitwise(grid, upa_min, b):
    t, j, elev, _ = grid
    got = t.floodplains(elev, upa_min=upa_min, b=b)
    want = j.floodplains(elev, upa_min=upa_min, b=b)
    assert got.dtype == np.int8 and got.shape == t.shape
    upa, margin, thresh = _flood_args(t, elev, upa_min, b)
    diff = (got != want).ravel()
    # a cell may differ only where its margin is within 1 ulp of the threshold
    near = np.abs(margin - thresh) <= np.spacing(thresh.astype(np.float32))
    assert not np.any(diff & ~near), f"{int(diff.sum())} cells differ"
    print(f"floodplains: {int(diff.sum())} cells differ, {int(near.sum())} within an ulp")
    assert set(np.unique(got)) <= {-1, 0, 1} and np.all(got[~t.mask.reshape(t.shape)] == -1)
    # the module function on tensors
    fld = tdem.floodplains(t._ds, torch.as_tensor(elev.ravel()), torch.as_tensor(upa),
                           upa_min=upa_min, b=b)
    assert np.array_equal(fld.numpy(), got.ravel())


def test_adjust_elevation_bitwise(grid):
    t, j, elev, rng = grid
    z = elev + rng.rand(*t.shape) * 3  # bumps to dig and fill
    got = tdem.adjust_elevation(t.idxs_ds, t.rank, z.ravel())
    want = jdem.adjust_elevation(j.idxs_ds, j.rank.ravel(), z.ravel())
    assert np.array_equal(got, want)
    ids = t.idxs_ds
    ok = (t.rank.ravel() >= 0) & (ids != np.arange(t.size))
    assert np.all(got[ids[ok]] <= got[ok])
    for dt in (np.float32, np.float64):
        out = t.dem_adjust(z.astype(dt))
        assert out.dtype == dt and np.array_equal(out, j.dem_adjust(z.astype(dt)))


@pytest.mark.parametrize("profile", [[8.0, 7, 6, 5, 5, 6, 5, 4], [8.0, 7, 3, 7, 7, 6, 5, 4],
                                     [8.0, 7, 6, 5, 4, 3, 2, 1], [1.0, 2, 3, 1, 5, 0, 4, 2]])
def test_adjust_elevation_profile_bitwise(profile):
    for dt in (np.float32, np.float64):
        p = np.array(profile, dt)
        got = tdem._adjust_elevation_profile(p)
        assert got.dtype == dt and np.array_equal(got, jdem._adjust_elevation_profile(p))
        assert np.all(np.diff(got) <= 0)


def test_dig_4connectivity_bitwise(grid):
    t, j, elev, _ = grid
    rivmsk = t.upstream_area() >= 4
    for mask in (None, rivmsk):
        got = tdem.dig_4connectivity(t.idxs_ds, t.rank, elev.ravel(), t.shape,
                                     mask=None if mask is None else mask.ravel())
        want = jdem.dig_4connectivity(j.idxs_ds, j.rank.ravel(), elev.ravel(), j.shape,
                                      mask=None if mask is None else mask.ravel())
        assert np.array_equal(got, want)
        assert np.array_equal(t.dem_dig_d4(elev, rivmsk=mask), j.dem_dig_d4(elev, rivmsk=mask))
    for i, k in ((40, 53), (40, 40), (40, 27), (40, 29)):
        assert np.array_equal(tdem._local_d4(i, k, 13), jdem._local_d4(i, k, 13))


def _estuary_data(t, rng):
    """Widths shrinking upstream (a funnel) with noise, so that some chains
    stop early; elevations 0 near the pits, above elsewhere."""
    dst = t.stream_distance().astype(np.float64)
    w = np.where(dst >= 0, 1000.0 / (1 + np.maximum(dst, 0)) + rng.rand(*t.shape) * 20, 0.0)
    z = np.where(rng.rand(*t.shape) < 0.3, 5.0, 0.0)
    return dst, w, z


@pytest.mark.parametrize("kw", [dict(), dict(min_convergence=0.5), dict(max_elevtn=10)])
def test_classify_estuaries_bitwise(grid, kw):
    t, j, _, rng = grid
    dst, w, z = _estuary_data(t, rng)
    got = t.classify_estuaries(z, w, rivdst=dst, **kw)
    want = j.classify_estuaries(z, w, rivdst=dst, **kw)
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert set(np.unique(got)) <= {0, 1, 2}
    # rivdst from distnc (float32 metres), and the module function
    assert np.array_equal(t.classify_estuaries(z, w, **kw), j.classify_estuaries(z, w, **kw))
    est = trv.classify_estuary(t.idxs_ds, t.idxs_pit, dst.ravel(), w.ravel(), z.ravel(),
                               device=CPU, **kw)
    want2 = jrv.classify_estuary(jnp.asarray(j.idxs_ds), j.idxs_pit, dst.ravel(), w.ravel(),
                                 z.ravel(), **kw)
    assert np.array_equal(est.numpy(), np.asarray(want2))


def test_river_depth_bitwise(grid):
    t, j, elev, rng = grid
    q = rng.rand(*t.shape) * 100 + 1
    w = rng.rand(*t.shape) * 50 + 5
    for kw in (dict(rivslp=np.full(t.shape, 1e-3)), dict(rivslp=rng.rand(*t.shape) * 1e-2),
               dict(zs=elev, rivdst=t.distnc), dict(zs=elev, rivdst=t.distnc, manning=0.05),
               dict(zs=elev, rivdst=t.distnc, method="gvf", n_iter=1, n_substeps=4)):
        got = t.river_depth(q, w, **kw)
        assert got.shape == t.shape and np.array_equal(got, j.river_depth(q, w, **kw))
    assert np.all(got[~t.mask.reshape(t.shape)] == -9999.0)
    with pytest.raises(ValueError, match="Method unknown"):
        t.river_depth(q, w, method="bogus")


def test_rivdph_gvf_bitwise(grid):
    t, j, elev, rng = grid
    n = t.size
    args = (elev.ravel(), np.full(n, 2.0), rng.rand(n) * 100 + 1, np.asarray(t.distnc).ravel(),
            rng.rand(n) * 40 + 5, np.full(n, 0.03))
    got = trv.rivdph_gvf(t.idxs_ds, t.rank, *args)
    assert np.array_equal(got, jrv.rivdph_gvf(j.idxs_ds, j.rank.ravel(), *args))
    kw = dict(min_rivslp=1e-4, min_rivdph=0.5, eps=0.2, n_iter=1, n_substeps=8)
    assert np.array_equal(trv.rivdph_gvf(t.idxs_ds, t.rank, *args, **kw),
                          jrv.rivdph_gvf(j.idxs_ds, j.rank.ravel(), *args, **kw))


def test_flwdir_methods_bitwise(grid):
    """The graph object's methods (unit distances, no transform)."""
    t, j, elev, rng = grid
    ft = pyflwdir_torch.Flwdir(t.idxs_ds, device="cpu")
    fj = pyflwdir_tpu.Flwdir(j.idxs_ds)
    z = elev.ravel()
    assert np.array_equal(ft.dem_adjust(z), fj.dem_adjust(z))
    dst, w, zz = _estuary_data(t, rng)
    assert np.array_equal(ft.classify_estuaries(zz.ravel(), w.ravel()),
                          fj.classify_estuaries(zz.ravel(), w.ravel()))
    q = rng.rand(t.size) * 100 + 1
    assert np.array_equal(ft.river_depth(q, w.ravel() + 1, zs=z, rivdst=dst.ravel()),
                          fj.river_depth(q, w.ravel() + 1, zs=z, rivdst=dst.ravel()))


def test_new_entry_points_default_to_the_card(d8_small):
    """With no GPU and no ``device``, the upscaling, sub-grid, river and slope
    functions raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: entry points run on it")
    from pyflwdir_torch import subgrid, upscale

    t = pyflwdir_torch.from_array(d8_small, device="cpu")
    upa = t.upstream_area().ravel()
    z = np.ones(t.shape)
    for call in (lambda: pyflwdir_torch.slope(z),
                 lambda: trv.classify_estuary(t.idxs_ds, t.idxs_pit, z.ravel(), z.ravel(),
                                              z.ravel()),
                 lambda: upscale.ihu(t.idxs_ds, upa, t.shape, 3),
                 lambda: upscale.dmm(t.idxs_ds, upa, t.shape, 3),
                 lambda: upscale.ihu_tiled(t.idxs_ds, upa.astype(float), t.shape, 3),
                 lambda: subgrid.outlets(t.idxs_ds, upa, 3, t.shape),
                 lambda: subgrid.ucat_area(t.idxs_pit, t.idxs_ds, np.ones(t.size))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
