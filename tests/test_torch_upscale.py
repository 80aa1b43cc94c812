"""Upscaling: the port's ``upscale.py`` and ``FlwdirRaster.upscale`` /
``upscale_error`` against the JAX package's, on the CPU.

Every result is an index or a flag, so bitwise: the maps over every pixel
(cell edges, effective areas, exit and representative pixels, IHU's
outlet trace) that the port runs on the device, the lowres graphs of DMM,
EAM, EAM+ and IHU at cellsizes 5-40, the error and check walks, the
repairs, and the banded IHU on arrays and memory maps. Grids: ``d8_small``
and two seeded DEM grids (``tests/test_torch_order._grid``); the upstream
area in cells, equal in both packages. The golden disconnect counts of
the upstream reference grid run where its data is present."""

import warnings

import numpy as np
import pytest
import torch

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import upscale as tu
from pyflwdir_tpu import upscale as ju
from tests.test_torch_order import _grid

CPU = torch.device("cpu")
CELLSIZES = (5, 7, 10, 20, 40)
_LATLON = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)


@pytest.fixture(scope="module", params=["d8_small", "160x200", "128x192"])
def grid(request, d8_small):
    d8 = {"d8_small": d8_small, "160x200": _grid((160, 200)),
          "128x192": _grid((128, 192))}[request.param]
    t = pyflwdir_torch.from_array(d8, transform=_LATLON, latlon=True, device="cpu")
    j = pyflwdir_tpu.from_array(d8, transform=pyflwdir_tpu.Affine(*_LATLON), latlon=True)
    upa = t.upstream_area().ravel()
    assert np.array_equal(upa, j.upstream_area().ravel())
    return t, j, upa


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert x == y
        else:
            assert np.array_equal(np.asarray(x).astype(np.int64), np.asarray(y).astype(np.int64))


@pytest.mark.parametrize("cellsize", CELLSIZES)
def test_pixel_maps_bitwise(grid, cellsize):
    """The device masks and scatter-argmax maps against the JAX numpy
    ones, over every pixel."""
    t, j, upa = grid
    n, subncol = t.size, t.shape[1]
    shape = tu._lowres_shape(t.shape, cellsize)
    px = tu._Pixels(n, 0, subncol, cellsize, shape[1], CPU)
    sub = np.arange(n)
    for r_ratio in (0.5, 0.3):
        tab = tu._cell_table(tu._effare_rc, cellsize, CPU, r_ratio)
        assert np.array_equal(px.table(tab).numpy(), ju.effective_area(sub, subncol, cellsize,
                                                                       r_ratio))
    tab = tu._cell_table(tu._edge_rc, cellsize, CPU)
    assert np.array_equal(px.table(tab).numpy(), ju.cell_edge(sub, subncol, cellsize))
    assert np.array_equal(px.low.numpy(), ju.subidx_2_idx(sub, subncol, cellsize, shape[1]))
    assert np.array_equal(tu.map_celledge(t.idxs_ds, t.shape, cellsize),
                          ju.map_celledge(j.idxs_ds, j.shape, cellsize))
    assert np.array_equal(tu.map_effare(t.idxs_ds, t.shape, cellsize),
                          ju.map_effare(j.idxs_ds, j.shape, cellsize))
    args = (upa, t.shape, shape, cellsize)
    exit_t = tu.dmm_exitcell(t.idxs_ds, *args, device=CPU)
    rep_t = tu.eam_repcell(t.idxs_ds, *args, device=CPU)
    _same((exit_t, rep_t), (ju.dmm_exitcell(j.idxs_ds, *args),
                            ju.eam_repcell(j.idxs_ds, *args)))
    _same((tu.ihu_outlets(rep_t, t.idxs_ds, *args, device=CPU),),
          (ju.ihu_outlets(rep_t, j.idxs_ds, *args),))
    # the lockstep walks, on their own
    _same((tu.dmm_nextidx(exit_t, t.idxs_ds, t.shape, shape, cellsize),
           tu.eam_nextidx(rep_t, t.idxs_ds, t.shape, shape, cellsize)),
          (ju.dmm_nextidx(exit_t, j.idxs_ds, j.shape, shape, cellsize),
           ju.eam_nextidx(rep_t, j.idxs_ds, j.shape, shape, cellsize)))


def test_scatter_argmax_ties():
    """Ties go to the lowest pixel, no pixel above 0 gives -1, unselected
    pixels count for nothing."""
    upa = torch.tensor([3.0, 5.0, 5.0, 1.0, 0.0, -2.0, 9.0], dtype=torch.float64)
    tgt = torch.tensor([0, 0, 0, 1, 2, 2, 1])
    sel = torch.tensor([True, True, True, True, True, True, False])
    got = tu._scatter_argmax(sel, tgt, torch.arange(7), upa, 4)
    assert got.tolist() == [1, 3, -1, -1]


@pytest.mark.parametrize("method", ["dmm", "eam", "eam_plus", "ihu"])
@pytest.mark.parametrize("cellsize", CELLSIZES)
def test_upscale_methods_bitwise(grid, method, cellsize):
    t, j, upa = grid
    got = getattr(tu, method)(t.idxs_ds, upa, t.shape, cellsize, device=CPU)
    want = getattr(ju, method)(j.idxs_ds, upa, j.shape, cellsize)
    _same(got, want)
    assert got[0].dtype == got[1].dtype == np.int64


@pytest.mark.parametrize("cellsize", [5, 10])
def test_upscale_error_check_bitwise(grid, cellsize):
    t, j, upa = grid
    for method in ("dmm", "ihu"):
        idxs_ds1, idxs_out, _ = getattr(ju, method)(j.idxs_ds, upa, j.shape, cellsize)
        _same(tu.upscale_error(idxs_out, idxs_ds1, t.idxs_ds),
              ju.upscale_error(idxs_out, idxs_ds1, j.idxs_ds))
        for minlen in (0, cellsize * 0.25, cellsize * 0.5):
            _same(tu.upscale_check(idxs_out, idxs_ds1, t.idxs_ds, minlen=minlen),
                  ju.upscale_check(idxs_out, idxs_ds1, j.idxs_ds, minlen=minlen))
    with pytest.raises(ValueError):
        tu.upscale_error(idxs_out[:-1], idxs_ds1, t.idxs_ds)


def test_repairs_bitwise(grid):
    """The three public repair passes on IHU's construction state."""
    t, j, upa = grid
    cs = 5
    shape = tu._lowres_shape(t.shape, cs)
    geo = dict(subshape=t.shape, shape=shape, cellsize=cs)
    rep = ju.eam_repcell(j.idxs_ds, upa, **geo)
    out = ju.ihu_outlets(rep, j.idxs_ds, upa, **geo)
    ids1, broken = ju.ihu_nextidx(out, j.idxs_ds, **geo)
    _same(tu.ihu_nextidx(out, t.idxs_ds, **geo), (ids1, broken))
    got = tu.ihu_relocate_outlets(broken, ids1, out, t.idxs_ds, upa, **geo)
    want = ju.ihu_relocate_outlets(broken, ids1, out, j.idxs_ds, upa, **geo)
    _same(got, want)
    _same(tu.ihu_relocate_outlets(None, ids1, out, t.idxs_ds, upa, **geo),
          ju.ihu_relocate_outlets(None, ids1, out, j.idxs_ds, upa, **geo))
    ids2, out2 = got[:2]
    valid, strm, still, short = ju.upscale_check(out2, ids2, j.idxs_ds, minlen=cs * 0.5)
    kw = dict(minlen=cs * 0.5, minupa=cs**2 * 0.25, **geo)
    s_t, s_j = strm.copy(), strm.copy()
    _same(tu.ihu_optimize_rivlen(short, valid, s_t, ids2, out2, t.idxs_ds, upa, **kw),
          ju.ihu_optimize_rivlen(short, valid, s_j, ids2, out2, j.idxs_ds, upa, **kw))
    assert np.array_equal(s_t, s_j)
    for pit_out in (0, 2):
        _same(tu.ihu_minimize_error(still, valid, s_t.copy(), ids2, out2, t.idxs_ds, upa,
                                    pit_out_of_cell=pit_out, **kw),
              ju.ihu_minimize_error(still, valid, s_j.copy(), ids2, out2, j.idxs_ds, upa,
                                    pit_out_of_cell=pit_out, **kw))
    # the inputs stay as they were
    assert np.array_equal(ids2, got[0]) and np.array_equal(out2, got[1])


@pytest.mark.parametrize("cellsize", [5, 10, 20])
def test_ihu_tiled_bitwise(grid, cellsize, tmp_path):
    """With no walk leaving its halo, the banded IHU at bands of 2, 3 and
    1000 lowres rows, on arrays and on memory maps, equals the JAX
    package's IHU and its banded IHU (one band: the JAX package runs each
    band's ``reach`` eagerly, 0.1 s a band)."""
    t, j, upa = grid
    ds64 = t.idxs_ds.astype(np.int64)
    upa64 = upa.astype(np.float64)
    want = ju.ihu(j.idxs_ds, upa, j.shape, cellsize)
    _same(ju.ihu_tiled(ds64, upa64, j.shape, cellsize, band_rows=1000), want)
    fd = np.memmap(tmp_path / "ds.bin", dtype=np.int64, mode="w+", shape=ds64.shape)
    fu = np.memmap(tmp_path / "upa.bin", dtype=np.float64, mode="w+", shape=upa64.shape)
    fd[:], fu[:] = ds64, upa64
    for band_rows in (2, 3, 1000):
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no walk leaves the default halo here
            got = tu.ihu_tiled(ds64, upa64, t.shape, cellsize, band_rows=band_rows, device=CPU)
        _same(got, want)
        _same(tu.ihu_tiled(fd, fu, t.shape, cellsize, band_rows=band_rows, device=CPU), want)


@pytest.mark.parametrize("shape,cellsize,band_rows", [((160, 200), 5, 16), ((128, 192), 3, 8)])
def test_ihu_tiled_escapes_bitwise(shape, cellsize, band_rows):
    """With a halo of one lowres row, walks leave their band: flagged,
    counted and warned about as in the JAX package, with the same result.
    (With no halo a walk can end with no next cell, whose repair reads
    outside the arrays in the shared native library: not a case to hold
    the two packages to.)"""
    t = pyflwdir_torch.from_array(_grid(shape), device="cpu")
    ds64 = t.idxs_ds.astype(np.int64)
    upa64 = t.upstream_area().ravel().astype(np.float64)
    kw = dict(band_rows=band_rows, halo_rows=1)
    with pytest.warns(UserWarning, match="left the 1-row halo") as rec_t:
        got = tu.ihu_tiled(ds64, upa64, t.shape, cellsize, device=CPU, **kw)
    with pytest.warns(UserWarning, match="left the 1-row halo") as rec_j:
        want = ju.ihu_tiled(ds64, upa64, t.shape, cellsize, **kw)
    _same(got, want)
    assert str(rec_t[0].message) == str(rec_j[0].message)


@pytest.mark.parametrize("kwargs", [dict(niter=1), dict(opt_rivlen=False), dict(min_error=False),
                                    dict(minlen_ratio=0.5, minupa_ratio=0.5, r_ratio=0.3),
                                    dict(pit_out_of_cell=0)])
def test_ihu_options_bitwise(grid, kwargs):
    t, j, upa = grid
    _same(tu.ihu(t.idxs_ds, upa, t.shape, 7, device=CPU, **kwargs),
          ju.ihu(j.idxs_ds, upa, j.shape, 7, **kwargs))


def test_object_upscale(grid):
    t, j, _ = grid
    for method in ("ihu", "eam_plus", "eam", "dmm"):
        ft, out_t = t.upscale(10, method=method)
        fj, out_j = j.upscale(10, method=method)
        assert ft.device == t.device and ft.shape == fj.shape and ft.isvalid
        assert np.array_equal(ft.idxs_ds, fj.idxs_ds) and np.array_equal(out_t, out_j)
        assert tuple(ft.transform) == tuple(fj.transform) and ft.latlon == fj.latlon
        assert tuple(ft.transform)[0] == t.transform[0] * 10
        err_t = t.upscale_error(ft, out_t)
        assert err_t.shape == ft.shape and np.array_equal(err_t, j.upscale_error(fj, out_j))
    with pytest.raises(ValueError, match="Unknown method"):
        t.upscale(10, method="bogus")
    for old, new in (("com", "eam_plus"), ("com2", "ihu")):
        with pytest.warns(DeprecationWarning, match=f"{old} renamed to {new}"):
            f_old, o_old = t.upscale(10, method=old)
        f_new, o_new = t.upscale(10, method=new)
        assert np.array_equal(f_old.idxs_ds, f_new.idxs_ds) and np.array_equal(o_old, o_new)
    upa_km2 = t.upstream_area("km2")
    ft, out_t = t.upscale(5, uparea=upa_km2)
    fj, out_j = j.upscale(5, uparea=upa_km2)
    assert np.array_equal(ft.idxs_ds, fj.idxs_ds) and np.array_equal(out_t, out_j)


def test_object_upscale_nextxy_raises():
    nx = np.array([[[2, 3], [3, -9]], [[1, 2], [2, -9]]], dtype=np.int32)
    t = pyflwdir_torch.from_array(nx, ftype="nextxy", device="cpu")
    with pytest.raises(ValueError, match="D8 or LDD"):
        t.upscale(2)


# golden disconnect counts of the upstream reference grid
GOLDEN = [
    (20, "dmm", 33),
    (20, "eam", 4),
    (20, "eam_plus", 2),
    (40, "ihu", 0),
    (20, "ihu", 1),
    (10, "ihu", 4),
    (5, "ihu", 7),
]


@pytest.mark.parametrize("cellsize,method,n_disconnect", GOLDEN)
def test_upscale_quality_reference(d8_ref_large, cellsize, method, n_disconnect):
    t = pyflwdir_torch.from_array(d8_ref_large, ftype="d8", device="cpu")
    upa = t.upstream_area("cell").ravel()
    idxs_ds1, idxs_out, _ = getattr(tu, method)(t.idxs_ds, upa, t.shape, cellsize, device=CPU)
    f1 = pyflwdir_torch.Flwdir(idxs_ds1, device="cpu")
    assert f1.isvalid and f1.idxs_pit.size >= 1
    assert tu.upscale_error(idxs_out, idxs_ds1, t.idxs_ds)[1].size == n_disconnect
