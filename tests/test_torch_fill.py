"""The port's device depression fill against the JAX package on the CPU:
one sweep (the plain version of kernel F1 against the JAX ``_sweep`` and
the Pallas ``_sweep_strip`` in interpret mode), ``fill_depressions_dev``
against the JAX function and the host priority flood, ``d8_from_filled``
and ``from_dem``. Only max and min act on the float32 values, so every
comparison is bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import kernels
from pyflwdir_torch import raster as traster
from pyflwdir_torch.ops import fill as tfill
from pyflwdir_tpu.ops import fill as jfill
from pyflwdir_tpu import runtime
from tests.test_dem import WANG_LIU


def _tilted(shape, seed, scale=10.0, tilt=5.0):
    rng = np.random.RandomState(seed)
    H, W = shape
    z = rng.rand(H, W).astype(np.float32) * scale
    return z + np.add.outer(np.linspace(tilt, 0, H), np.linspace(tilt, 0, W)).astype(np.float32)


def _sweep_inputs(shape, seed):
    """One sweep's inputs: a DEM with nodata, its seeds, and an upper bound
    holding finite values and +inf."""
    rng = np.random.RandomState(seed)
    z = _tilted(shape, seed)
    z[rng.rand(*shape) < 0.05] = -9999.0
    dem, seeds, bad = tfill.fill_setup(z, device="cpu")
    up = np.where(rng.rand(*shape) < 0.3, np.inf, z + 3 * rng.rand(*shape)).astype(np.float32)
    w = torch.where(bad, float("inf"), torch.where(seeds, dem, torch.as_tensor(up)))
    return w, dem, (seeds | bad).to(torch.uint8)


# (name, shape, row made special): the kernel's layout edges (1,024 threads,
# K columns a thread; rows not 16-byte aligned), one row, and a row all
# fixed or all +inf; the first case keeps the test's original ids
_SWEEP_CASES = [
    ("61x77", (61, 77), None),
    ("ncol1", (9, 1), None),
    ("ncol2", (9, 2), None),
    ("ncol33", (7, 33), None),
    ("ncol1025", (5, 1025), None),
    ("nrow1", (1, 77), None),
    ("fixed_row", (9, 40), "fixed"),
    ("inf_row", (9, 40), "inf"),
]


def _edge_sweep_inputs(shape, special):
    w, dem, fixed = _sweep_inputs(shape, 1)
    if special == "fixed":
        fixed[4] = 1
        w[4] = dem[4]
    elif special == "inf":
        fixed[4] = 0
        w[4] = float("inf")
    return w, dem, fixed


@pytest.mark.parametrize("conn8,down,shape,special", [
    pytest.param(conn8, down, shape, special,
                 id=f"{conn8}-{down}" if name == "61x77" else f"{name}-{conn8}-{down}")
    for name, shape, special in _SWEEP_CASES
    for conn8 in (True, False) for down in (True, False)])
def test_sweep_plain_matches_jax(conn8, down, shape, special):
    w, dem, fixed = _edge_sweep_inputs(shape, special)
    kernels.reset_launches()
    got = kernels.fill_sweep(w, dem, fixed, conn8, down)
    assert kernels.launches["fill_sweep"] == 0  # a CPU tensor takes the plain version
    want = jfill._sweep(jnp.asarray(w.numpy()), jnp.asarray(dem.numpy()),
                        jnp.asarray(fixed.numpy() != 0), conn8, down=down)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,conn8,down", [((128, 256), True, True),
                                              ((100, 200), False, False)])
def test_sweep_plain_matches_strip_kernel(shape, conn8, down):
    """Against the TPU kernel itself, in interpret mode: padded to strips of
    64 rows and 128 lanes with fixed +inf cells, and flipped for the up
    sweep, as the JAX package's ``_erode_from`` runs it."""
    w, dem, fixed = _sweep_inputs(shape, 11)
    got = kernels.fill_sweep_plain(w, dem, fixed, conn8, down).numpy()
    H, W = shape
    pad = ((0, (-H) % 64), (0, (-W) % 128))
    wj = np.pad(w.numpy(), pad, constant_values=np.inf)
    dj = np.pad(dem.numpy(), pad, constant_values=np.inf)
    fj = np.pad(fixed.numpy() != 0, pad, constant_values=True)
    if not down:
        wj, dj, fj = wj[::-1], dj[::-1], fj[::-1]
    out = np.asarray(jfill._sweep_strip(jnp.asarray(wj), jnp.asarray(dj), jnp.asarray(fj),
                                        conn8))
    if not down:
        out = out[::-1]
    assert np.array_equal(got, out[:H, :W])


def _random(seed, shape, n, scale, holes):
    rng = np.random.RandomState(seed)
    grids = []
    for _ in range(n):
        a = np.round(rng.rand(*shape) * scale).astype(np.float64)
        if holes:
            a[rng.rand(*shape) < 0.04] = -9999.0
        grids.append(a)
    return grids


def _holed():
    """The 197 x 243 grid of the JAX package's multigrid test: a hole and an
    irregular boundary of nodata."""
    H, W = 197, 243
    z = _tilted((H, W), 71, tilt=5.0)
    z[40:60, 50:80] = -9999.0
    yy, xx = np.mgrid[0:H, 0:W]
    z[((yy - H / 2) ** 2 + (xx - W / 2) ** 2) > (0.65 * max(H, W)) ** 2] = -9999.0
    return z


def _nan_grid():
    z = _tilted((40, 52), 5)
    z[10:14, 20:30] = np.nan
    z[0, :7] = np.nan
    return z


_NODATA_ROW = WANG_LIU.copy()
_NODATA_ROW[3, 5:] = -9999
# (dem, keyword arguments, whether the host priority flood gives the same
# surface: it picks other interior pits under a depth cap on arbitrary grids)
_CASES = {
    "wang_liu": (WANG_LIU, {}, True),
    "wang_liu_conn4": (WANG_LIU, dict(connectivity=4), True),
    "outlets_min": (WANG_LIU, dict(outlets="min"), True),
    "nodata_row": (_NODATA_ROW, {}, True),
    **{f"random{i}": (a, {}, True) for i, a in enumerate(_random(3, (30, 41), 4, 40, True))},
    "elv_max": (WANG_LIU, dict(elv_max=6.0), True),
    "idxs_pit": (WANG_LIU, dict(idxs_pit=[27, 5]), True),
    "nan_nodata": (_nan_grid(), dict(nodata=np.nan), True),
    "max_depth_wang_liu": (WANG_LIU, dict(max_depth=2), True),
    **{f"max_depth_random{i}": (a, dict(max_depth=3.0), False)
       for i, a in enumerate(_random(4, (20, 25), 3, 30, False))},
    "multigrid": (_holed(), dict(multigrid_min=16), True),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_fill_and_d8_match_jax(case):
    dem, kw, host_equal = _CASES[case]
    got = tfill.fill_depressions_dev(dem, device="cpu", **kw)
    rounds = tfill.last_rounds["fill"]
    want = np.asarray(jfill.fill_depressions_dev(dem, **kw))
    assert got.dtype == torch.float32 and got.device.type == "cpu" and rounds > 0
    assert np.array_equal(got.numpy(), want, equal_nan=True)
    if host_equal:
        host_kw = {k: v for k, v in kw.items() if k != "multigrid_min"}
        host = runtime.priority_flood(np.asarray(dem, np.float64), **host_kw)[0]
        assert np.array_equal(got.numpy(), host.astype(np.float32), equal_nan=True)
    nodata = kw.get("nodata", -9999.0)
    d8 = tfill.d8_from_filled(got, nodata=nodata)
    assert d8.dtype == torch.uint8 and tfill.last_rounds["flat"] > 0
    assert np.array_equal(d8.numpy(), np.asarray(jfill.d8_from_filled(want, nodata=nodata)))


def test_fill_max_rounds_stops_silently():
    """A fill cut at max_rounds stops there without a word, as the JAX
    package's; the round count tells."""
    z = _holed()
    got = tfill.fill_depressions_dev(z, max_rounds=1, device="cpu")
    assert tfill.last_rounds["fill"] == 1
    want = np.asarray(jfill.fill_depressions_dev(z, max_rounds=1))
    assert np.array_equal(got.numpy(), want)


_DEM = _tilted((96, 80), 4, scale=1.0, tilt=2.0)
_DEM_HOLES = _DEM.copy()
_DEM_HOLES[30:34, 10:50] = -9999.0


@pytest.mark.parametrize("engine,dem,kw", [
    ("device", _DEM, {}),
    ("device", _DEM_HOLES, dict(outlets="min")),
    ("device", _DEM_HOLES, dict(max_depth=0.5)),
    ("host", _DEM_HOLES, {}),
    ("auto", _DEM_HOLES, {}),
], ids=["device", "device-min", "device-max_depth", "host", "auto"])
def test_from_dem_matches_jax(engine, dem, kw):
    t = pyflwdir_torch.from_dem(dem, engine=engine, device="cpu", **kw)
    j = pyflwdir_tpu.from_dem(dem, engine=engine, **kw)
    assert t.device.type == "cpu" and t.shape == j.shape
    assert np.array_equal(t.idxs_ds, j.idxs_ds)
    assert np.array_equal(t.idxs_pit, j.idxs_pit)
    ua = t.upstream_area()
    assert int(ua.ravel()[t.idxs_pit].sum()) == int(t.mask.sum())


def test_from_dem_auto_rule(monkeypatch):
    """engine="auto" fills on a CUDA device from 2^21 cells up, else on the
    host: the rule's own function (no card here), then a CPU call that must
    not reach the device fill."""
    n = traster._FROM_DEM_DEV_MIN
    assert n == 1 << 21
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert traster._from_dem_engine(cpu, 4 * n) == "host"
    assert traster._from_dem_engine(cuda, n - 1) == "host"
    assert traster._from_dem_engine(cuda, n) == "device"
    calls = []
    real = tfill.fill_depressions_dev
    monkeypatch.setattr(tfill, "fill_depressions_dev",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(traster, "_FROM_DEM_DEV_MIN", 0)
    pyflwdir_torch.from_dem(_DEM, device="cpu")
    assert not calls
    pyflwdir_torch.from_dem(_DEM, engine="device", device="cpu")
    assert calls == [1]
    with pytest.raises(ValueError, match="Unknown engine"):
        pyflwdir_torch.from_dem(_DEM, engine="gpu", device="cpu")
