"""``codecs.convert`` (``d8_to_ldd``, ``ldd_to_d8``) and
``FlwdirRaster.to_array`` of the port against the JAX package's, on seeded
rasters with nodata cells, pits and codes of neither kind."""

import numpy as np
import pytest

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import dem as tdem
from pyflwdir_torch.codecs import convert as tconv
from pyflwdir_tpu.codecs import convert as jconv


def _d8(shape=(40, 52), seed=3):
    """A D8 raster with nodata cells and pits of both codes (0 and 255)."""
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape) + np.add.outer(np.linspace(1, 0, shape[0]), np.linspace(1, 0, shape[1]))
    d8 = tdem.fill_depressions(z)[1]
    d8[3, 4:9] = 247
    d8[10, 10] = 0
    d8[20, 30] = 255
    return d8


def test_convert_every_code():
    """All 256 byte values, known and unknown, map as in the JAX package."""
    codes = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert np.array_equal(tconv.d8_to_ldd(codes), jconv.d8_to_ldd(codes))
    assert np.array_equal(tconv.ldd_to_d8(codes), jconv.ldd_to_d8(codes))
    assert pyflwdir_torch.d8_to_ldd is tconv.d8_to_ldd
    assert pyflwdir_torch.codecs.ldd_to_d8 is tconv.ldd_to_d8


@pytest.mark.parametrize("seed", [3, 4])
def test_convert_round_trip(seed):
    d8 = _d8(seed=seed)
    ldd = tconv.d8_to_ldd(d8)
    assert ldd.dtype == np.uint8 and np.array_equal(ldd, jconv.d8_to_ldd(d8))
    assert np.all(ldd[d8 == 247] == 255) and ldd[10, 10] == 5 and ldd[20, 30] == 5
    back = tconv.ldd_to_d8(ldd)
    assert np.array_equal(back, jconv.ldd_to_d8(ldd))
    pits = (d8 == 0) | (d8 == 255)
    assert np.array_equal(back[~pits], d8[~pits]) and np.all(back[pits] == 0)


@pytest.mark.parametrize("ftype", [None, "d8", "ldd", "nextxy"])
@pytest.mark.parametrize("src", ["d8", "ldd"])
def test_to_array(src, ftype):
    d8 = _d8()
    data = d8 if src == "d8" else tconv.d8_to_ldd(d8)
    got = pyflwdir_torch.from_array(data, ftype=src, device="cpu").to_array(ftype)
    want = pyflwdir_tpu.from_array(data, ftype=src).to_array(ftype)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if ftype in (None, src):
        pits = (d8 == 0) | (d8 == 255) if src == "d8" else data == 5
        assert np.array_equal(got[~pits], data[~pits])


def test_to_array_unknown_ftype():
    fl = pyflwdir_torch.from_array(_d8(), device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        fl.to_array("d16")
