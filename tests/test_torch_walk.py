"""Walks and window gathers: the port's ``ops/walk.py``, the index-set
helpers of ``ops/graph.py``, the ``trace_walks`` binding and the objects'
``path`` / ``snap`` against the JAX package's, on the CPU. Windows, paths,
end cells and index sets bitwise (the port's indices are int64, the JAX
package's int32: values are compared); path lengths bitwise too, the same
native walk over step tables made by the same formula. Grids: the 15x12
``d8_small`` and the 128x192 grid of ``test_torch_order``, under a latlon
and a projected transform."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import runtime as trt
from pyflwdir_torch.ops import graph as tgraph
from pyflwdir_torch.ops import walk as twalk
from pyflwdir_tpu import runtime as jrt
from pyflwdir_tpu.ops import graph as jgraph
from pyflwdir_tpu.ops import walk as jwalk
from tests.test_torch_order import _grid

_TRANSFORMS = {
    "latlon": ((0.01, 0.0, 5.0, 0.0, -0.01, 52.0), True),
    "projected": ((30.0, 0.0, 400000.0, 0.0, -25.0, 5800000.0), False),
}


@pytest.fixture(scope="module", params=[(g, tf) for g in ("d8_small", "128x192")
                                        for tf in _TRANSFORMS])
def rasters(request, d8_small):
    grid, tf = request.param
    d8 = d8_small if grid == "d8_small" else _grid((128, 192))
    transform, latlon = _TRANSFORMS[tf]
    j = pyflwdir_tpu.from_array(d8, transform=transform, latlon=latlon)
    t = pyflwdir_torch.from_array(d8, transform=transform, latlon=latlon, device="cpu")
    return d8, j, t


def _seeds(t, k=40, seed=3):
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(np.flatnonzero(t.mask), min(k, int(t.mask.sum())), replace=False))


def _same_paths(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert y.dtype == np.int64 and np.array_equal(x, y)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("with_strord", [False, True])
def test_window_indices_bitwise(rasters, n, with_strord):
    _, j, t = rasters
    assert np.array_equal(t.idxs_us_main, j.idxs_us_main)
    strord = t.stream_order().ravel() if with_strord else None
    want = np.asarray(jwalk.window_indices(
        jnp.asarray(j.idxs_ds), jnp.asarray(j.idxs_us_main), n,
        None if strord is None else jnp.asarray(strord)))
    got = twalk.window_indices(
        t._ds, torch.as_tensor(t.idxs_us_main), n,
        None if strord is None else torch.as_tensor(strord)).numpy()
    assert got.dtype == np.int64 and got.shape == (2 * n + 1, t.size)
    assert np.array_equal(got, want)
    if with_strord and n > 1:  # the stop compares with the window's own cell
        down = got[n + 1:]
        inside = down >= 0
        assert np.all(strord[down[inside]] <= np.broadcast_to(strord, down.shape)[inside])


@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("unit", ["cell", "m"])
@pytest.mark.parametrize("limit", [False, True])
def test_path_snap_bitwise(rasters, direction, unit, limit):
    _, j, t = rasters
    seeds = _seeds(t)
    if limit:
        max_length = 6 if unit == "cell" else 6 * abs(t.transform[0]) * (
            111_000 if t.latlon else 1)
    else:
        max_length = None
    kw = dict(idxs=seeds, unit=unit, direction=direction, max_length=max_length)
    pa, da = j.path(**kw)
    pb, db = t.path(**kw)
    _same_paths(pa, pb)
    assert db.dtype == np.float64 and np.array_equal(da, db)
    ea, sa = j.snap(**kw)
    eb, sb = t.snap(**kw)
    assert eb.dtype == np.int64 and np.array_equal(ea, eb)
    assert sb.dtype == np.float32 and np.array_equal(sa, sb)
    assert np.array_equal(eb, [p[-1] for p in pb])


@pytest.mark.parametrize("direction", ["down", "up"])
def test_path_snap_mask_bitwise(rasters, direction):
    _, j, t = rasters
    upa = t.upstream_area()
    stream = upa >= 20
    seeds = _seeds(t, seed=5)
    pa, da = j.path(idxs=seeds, mask=stream, direction=direction)
    pb, db = t.path(idxs=seeds, mask=stream, direction=direction)
    _same_paths(pa, pb)
    assert np.array_equal(da, db)
    ea, _ = j.snap(idxs=seeds, mask=stream, direction=direction)
    eb, _ = t.snap(idxs=seeds, mask=stream, direction=direction)
    assert np.array_equal(ea, eb)
    if direction == "down":  # each end a stream cell or a pit
        pit = t.idxs_ds[eb] == eb
        assert np.all(stream.ravel()[eb] | pit)


def test_graph_object_path_snap(rasters):
    """``Flwdir.path`` / ``snap`` (unit steps, no ``ncol``) on the 1-D graph."""
    _, j, t = rasters
    jf = pyflwdir_tpu.Flwdir(j.idxs_ds)
    tf = pyflwdir_torch.Flwdir(t.idxs_ds, device="cpu")
    seeds = _seeds(t, seed=7)
    for direction in ("down", "up"):
        pa, da = jf.path(idxs=seeds, direction=direction, max_length=4)
        pb, db = tf.path(idxs=seeds, direction=direction, max_length=4)
        _same_paths(pa, pb)
        assert np.array_equal(da, db)
        assert np.array_equal(jf.snap(idxs=seeds, direction=direction)[0],
                              tf.snap(idxs=seeds, direction=direction)[0])
    with pytest.raises(ValueError):
        tf.path(idxs=seeds, direction="sideways")


def test_trace_and_step_tables(rasters):
    _, j, t = rasters
    nrow = t.shape[0]
    for a, b in zip(jwalk._step_tables(nrow, t.latlon, t.transform),
                    twalk._step_tables(nrow, t.latlon, t.transform)):
        assert np.array_equal(a, b)
    seed = int(_seeds(t, k=1)[0])
    pa, da = jwalk.trace(seed, j.idxs_ds, ncol=t.shape[1], real_length=True,
                         latlon=t.latlon, transform=t.transform)
    pb, db = twalk.trace(seed, t.idxs_ds, ncol=t.shape[1], real_length=True,
                         latlon=t.latlon, transform=t.transform)
    assert np.array_equal(pa, pb) and da == db


def test_trace_walks_binding(rasters):
    _, _, t = rasters
    seeds = _seeds(t)
    mask = (np.random.RandomState(2).rand(t.size) < 0.1).astype(np.uint8)
    for kw in (dict(), dict(mask=mask), dict(max_length=3.0)):
        for a, b in zip(jrt.trace_walks(t.idxs_ds, seeds, **kw),
                        trt.trace_walks(t.idxs_ds, seeds, **kw)):
            assert np.array_equal(a, b)


def test_index_sets_bitwise(rasters):
    _, j, t = rasters
    ids = t.idxs_ds
    mask = np.random.RandomState(4).rand(ids.size) < 0.8
    dev = torch.as_tensor(ids)
    assert np.array_equal(tgraph.pit_indices(ids), jgraph.pit_indices(j.idxs_ds))
    assert np.array_equal(tgraph.loop_indices(dev), jgraph.loop_indices(j.idxs_ds))
    for m in (None, mask):
        tm = None if m is None else torch.as_tensor(m)
        assert np.array_equal(tgraph.headwater_indices(dev, tm),
                              jgraph.headwater_indices(j.idxs_ds, m))
        assert np.array_equal(tgraph.confluence_indices(dev, tm),
                              jgraph.confluence_indices(j.idxs_ds, m))
        got = tgraph.flwdir_tuples(ids, None if m is None else m.astype(np.uint8))
        want = jgraph.flwdir_tuples(j.idxs_ds, None if m is None else m.astype(np.uint8))
        assert len(got) == len(want)
        assert all(np.array_equal(a, b) and a.dtype == np.int64 for a, b in zip(got, want))
    assert np.array_equal(tgraph.upstream_matrix(ids), jgraph.upstream_matrix(j.idxs_ds))
    seq = tgraph.idxs_seq(dev)
    assert seq.dtype == np.int64 and np.array_equal(seq, jgraph.idxs_seq(j.idxs_ds))
    pits = t.idxs_pit[::2]
    assert np.array_equal(tgraph.idxs_seq(dev, pits), jgraph.idxs_seq(j.idxs_ds, pits))


def test_index_sets_on_a_cycle():
    # a 3-cycle, a cell draining into it, a chain to a pit, a missing cell
    ids = np.array([1, 2, 0, 0, 5, 5, -1], dtype=np.int64)
    dev = torch.as_tensor(ids)
    assert np.array_equal(tgraph.loop_indices(dev), jgraph.loop_indices(ids))
    assert np.array_equal(tgraph.loop_indices(dev), [0, 1, 2, 3])
    assert np.array_equal(tgraph.idxs_seq(dev), jgraph.idxs_seq(ids))
    assert np.array_equal(tgraph.pit_indices(ids), [5])
