"""``pyflwdir_torch.ops.stencil`` against the JAX package's ``ops/stencil.py``
on the CPU: ``decode_d8``, ``decode_ldd``, ``idxs_ds_from_d8`` and
``local_pointers`` bitwise on seeded D8 and LDD rasters with nodata cells
and cells pointing off the grid; ``idxs_ds_from_d8`` also equal to
``codecs.d8.from_array``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.codecs import ldd as tldd
from pyflwdir_torch.ops import stencil
from pyflwdir_tpu.ops import stencil as jstencil

SHAPES = [(1, 1), (3, 5), (17, 23), (64, 96)]


def _d8(shape, seed):
    """Every D8 code (pits 0 and 255, nodata 247) at random, so edge cells
    point off the grid and cells drain into nodata."""
    rng = np.random.RandomState(seed)
    codes = np.array([0, 1, 2, 4, 8, 16, 32, 64, 128, 255, 247], np.uint8)
    return codes[rng.randint(0, codes.size, shape)]


def _ldd(shape, seed):
    rng = np.random.RandomState(seed)
    return np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 255], np.uint8)[rng.randint(0, 10, shape)]


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_decode(shape):
    d8, ldd = _d8(shape, 1), _ldd(shape, 2)
    for got, want in ((stencil.decode_d8(torch.as_tensor(d8)), jstencil.decode_d8(jnp.asarray(d8))),
                      (stencil.decode_ldd(torch.as_tensor(ldd)),
                       jstencil.decode_ldd(jnp.asarray(ldd)))):
        for g, w in zip(got, want):
            _eq(g, w)
    dr, dc, valid = stencil.decode_d8(torch.as_tensor(d8))
    assert dr.dtype == dc.dtype == torch.int32 and valid.dtype == torch.bool
    assert np.array_equal(dr.numpy(), td8._DR_LUT[d8]) and np.array_equal(valid.numpy(), d8 != 247)
    assert np.array_equal(stencil.decode_ldd(torch.as_tensor(ldd))[0].numpy(), tldd._DR_LUT[ldd])


@pytest.mark.parametrize("shape", SHAPES)
def test_idxs_ds_from_d8(shape):
    d8 = _d8(shape, 3)
    got = stencil.idxs_ds_from_d8(torch.as_tensor(d8))
    _eq(got, jstencil.idxs_ds_from_d8(jnp.asarray(d8)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), td8.from_array(d8, dtype=np.int64)[0])


@pytest.mark.parametrize("shape", SHAPES)
def test_local_pointers(shape):
    d8 = _d8(shape, 4)
    got = stencil.local_pointers(torch.as_tensor(d8))
    want = jstencil.local_pointers(jnp.asarray(d8))
    for g, w in zip(got, want):
        _eq(g, w)


def test_a_filled_dem_and_an_int_raster():
    """A valid D8 raster (every cell drains) and the same codes held as
    int32, which both packages take as uint8."""
    from pyflwdir_torch import dem

    rng = np.random.RandomState(5)
    z = rng.rand(40, 50) + np.add.outer(np.linspace(1, 0, 40), np.linspace(1, 0, 50))
    d8 = dem.fill_depressions(z)[1]
    d8[3:5, 7:9] = 247
    _eq(stencil.idxs_ds_from_d8(torch.as_tensor(d8.astype(np.int32))),
        jstencil.idxs_ds_from_d8(jnp.asarray(d8.astype(np.int32))))
    for g, w in zip(stencil.local_pointers(torch.as_tensor(d8)),
                    jstencil.local_pointers(jnp.asarray(d8))):
        _eq(g, w)


def test_arrays_go_to_the_card():
    """An array, not a tensor, goes to the card: without a GPU that raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    with pytest.raises(RuntimeError):
        stencil.decode_d8(np.zeros((2, 2), np.uint8))
