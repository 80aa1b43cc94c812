"""The port's ``Flwdir`` and ``FlwdirRaster`` take the JAX package's
constructor arguments in the JAX order, with ``device`` last: both packages
called with the same positional arguments give the same objects. A given
``area`` weights ``upstream_area()`` as in the JAX package (integer areas:
bitwise), and ``idxs_seq`` is kept."""

import numpy as np
import pytest

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch.codecs import d8 as td8
from tests.test_torch_tile_plan import _demo_d8

_LATLON = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)


@pytest.fixture(scope="module")
def graph():
    d8 = _demo_d8((40, 30), 13)
    ids, pits, _ = td8.from_array(d8, dtype=np.int64)
    seq = np.argsort(pyflwdir_torch.from_array(d8, device="cpu").rank.ravel(), kind="stable")
    area = np.random.RandomState(3).randint(1, 5, ids.size).astype(np.int32)
    return dict(d8=d8, ids=ids, pits=pits, seq=seq, area=area)


def test_flwdir_positional_arguments_as_in_jax(graph):
    ids, pits, seq, area = graph["ids"], graph["pits"], graph["seq"], graph["area"]
    args = (ids, area, pits, pits[:3], seq, int((ids >= 0).sum()), True)
    t = pyflwdir_torch.Flwdir(*args, device="cpu")
    j = pyflwdir_tpu.Flwdir(*args)
    assert np.array_equal(t.idxs_pit, j.idxs_pit) and np.array_equal(t.idxs_outlet, pits[:3])
    assert t._seq is seq and t.nnodes == j.nnodes and t.cache is True
    assert np.array_equal(t.area, area)
    upa = t.upstream_area()
    assert np.array_equal(upa, j.upstream_area())
    m = t.mask
    assert np.array_equal(upa[m], t.accuflux(area)[m]) and np.all(upa[~m] == -9999)
    unit = pyflwdir_torch.Flwdir(ids, device="cpu").upstream_area()
    assert not np.array_equal(upa, unit)  # the area weights it
    # keywords too, device last
    k = pyflwdir_torch.Flwdir(ids, area=area, idxs_seq=seq, device="cpu")
    assert np.array_equal(k.upstream_area(), upa)


def test_flwdir_raster_positional_arguments_as_in_jax(graph):
    ids, pits, seq = graph["ids"], graph["pits"], graph["seq"]
    shape = graph["d8"].shape
    args = (ids, shape, "d8", pits, pits[:2], seq, int((ids >= 0).sum()), _LATLON, True, True)
    t = pyflwdir_torch.FlwdirRaster(*args, device="cpu")
    j = pyflwdir_tpu.FlwdirRaster(*args)
    assert t.shape == j.shape == shape and t.ftype == j.ftype == "d8"
    assert tuple(t.transform) == tuple(j.transform) and t.latlon and j.latlon
    assert t._seq is seq and t.cache and np.array_equal(t.idxs_outlet, pits[:2])
    assert np.array_equal(t.upstream_area(), j.upstream_area())
    np.testing.assert_allclose(t.upstream_area("km2"), j.upstream_area("km2"), rtol=1e-12)
