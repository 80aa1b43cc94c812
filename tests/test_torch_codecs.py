"""Port codecs against the JAX package's codecs: bitwise equal parses,
encodings and type inference for d8, ldd and nextxy."""

import numpy as np
import pytest

from pyflwdir_torch import codecs as tcodecs
from pyflwdir_tpu import codecs as jcodecs


def _grids(d8):
    ldd = jcodecs.d8_to_ldd(d8)
    ids, _, _ = jcodecs.d8.from_array(d8)
    xy = jcodecs.nextxy.to_array(ids, d8.shape)
    return {"d8": d8, "ldd": ldd, "nextxy": xy}


@pytest.mark.parametrize("ftype", ["d8", "ldd", "nextxy"])
def test_from_array_bitwise(ftype, d8_small):
    data = _grids(d8_small)[ftype]
    j = getattr(jcodecs, ftype).from_array(data)
    t = getattr(tcodecs, ftype).from_array(data)
    for a, b in zip(j[:2], t[:2]):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)
    assert j[2] == t[2]
    # int64 indices, as the port's rasters hold them
    t64 = getattr(tcodecs, ftype).from_array(data, dtype=np.int64)
    assert t64[0].dtype == np.int64
    assert np.array_equal(t64[0], j[0]) and np.array_equal(t64[1], j[1])


@pytest.mark.parametrize("ftype", ["d8", "ldd", "nextxy"])
def test_to_array_bitwise(ftype, d8_small):
    ids, _, _ = jcodecs.d8.from_array(d8_small)
    a = getattr(jcodecs, ftype).to_array(ids, d8_small.shape)
    b = getattr(tcodecs, ftype).to_array(ids.astype(np.int64), d8_small.shape)
    assert a.dtype == b.dtype
    assert np.array_equal(a, b)


@pytest.mark.parametrize("ftype", ["d8", "ldd", "nextxy"])
def test_infer_ftype(ftype, d8_small):
    data = _grids(d8_small)[ftype]
    assert tcodecs.infer_ftype(data) == jcodecs.infer_ftype(data) == ftype


def test_infer_ftype_rejects_garbage():
    bad = np.full((4, 4), 3, dtype=np.int16)
    with pytest.raises(ValueError):
        tcodecs.infer_ftype(bad)
