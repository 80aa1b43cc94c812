"""Port pointer-doubling primitives against the JAX package's: rank, roots,
reach, the path reductions, downstream accumulation and nodata filling
bitwise equal (the same rounds combine the same pairs), on grids and on
graphs with cycles; the subtree reductions (``accumulate``,
``fillnodata_downstream``), ``upstream_count`` and ``main_upstream``
bitwise for integers, maxima and minima.

Float sums of the subtree reductions: the port adds each round's terms in
another order than the JAX scatter, and a cell's error grows by a few
roundings a round: rtol 1e-12 plus 2 L eps total, L the doubling rounds
times the graph's largest in-degree, the total the sum of the data's
magnitudes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import graph as tgraph
from pyflwdir_tpu.ops import graph as jgraph


def _cycle_graph(cycle_len):
    # a cycle, a cell draining into it, a chain to a pit, a missing cell
    n = cycle_len + 4
    ids = np.empty(n, dtype=np.int64)
    for i in range(cycle_len):
        ids[i] = (i + 1) % cycle_len
    ids[cycle_len] = 0
    ids[cycle_len + 1] = cycle_len + 2
    ids[cycle_len + 2] = cycle_len + 2
    ids[cycle_len + 3] = -1
    return ids


_EPS = np.finfo(np.float64).eps


def _graphs(d8_small):
    return {
        "d8_small": td8.from_array(d8_small, dtype=np.int64)[0],
        "cycle3": _cycle_graph(3),
        "cycle4": _cycle_graph(4),
    }


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
@pytest.mark.parametrize("fn", ["rank", "roots", "self_loop", "pit_mask", "valid_mask"])
def test_bitwise(d8_small, name, fn):
    ids = _graphs(d8_small)[name]
    want = np.asarray(getattr(jgraph, fn)(jnp.asarray(ids)))
    got = getattr(tgraph, fn)(torch.as_tensor(ids)).numpy()
    assert got.dtype == want.dtype or fn in ("roots", "self_loop")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
def test_reach_bitwise(d8_small, name):
    ids = _graphs(d8_small)[name]
    stop = np.random.RandomState(1).rand(ids.size) < 0.2
    want = np.asarray(jgraph.reach(jnp.asarray(ids), jnp.asarray(stop)))
    got = tgraph.reach(torch.as_tensor(ids), torch.as_tensor(stop)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cycle_len", [3, 4])
def test_rank_flags_cycles(cycle_len):
    got = tgraph.rank(torch.as_tensor(_cycle_graph(cycle_len))).numpy()
    assert np.all(got[: cycle_len + 1] == -1)
    assert list(got[cycle_len + 1 :]) == [1, 0, -9999]


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
@pytest.mark.parametrize("with_stop", [False, True])
def test_path_reduce_bitwise(d8_small, name, op, dtype, with_stop):
    ids = _graphs(d8_small)[name]
    rng = np.random.RandomState(2)
    w = (rng.rand(ids.size) * 100).astype(dtype)
    stop = (rng.rand(ids.size) < 0.2) if with_stop else None
    want = np.asarray(jgraph.path_reduce(
        jnp.asarray(ids), jnp.asarray(w), None if stop is None else jnp.asarray(stop), op))
    got = tgraph.path_reduce(torch.as_tensor(ids), torch.as_tensor(w),
                             None if stop is None else torch.as_tensor(stop), op).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    if op == "add":
        got = tgraph.path_sum(torch.as_tensor(ids), torch.as_tensor(w),
                              None if stop is None else torch.as_tensor(stop)).numpy()
        assert np.array_equal(got, want)


def test_path_reduce_rejects_unknown_ops():
    ids = torch.as_tensor(_cycle_graph(3))
    with pytest.raises(ValueError, match="unknown reduction"):
        tgraph.path_reduce(ids, torch.ones(ids.shape[0]), op="mean")


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
@pytest.mark.parametrize("dtype", [np.int64, np.float32])
@pytest.mark.parametrize("nodata", [None, -9999])
def test_accumulate_downstream_bitwise(d8_small, name, dtype, nodata):
    ids = _graphs(d8_small)[name]
    rng = np.random.RandomState(3)
    data = (rng.rand(ids.size) * 10).astype(dtype)
    if nodata is not None:
        data[rng.rand(ids.size) < 0.15] = nodata
    want = np.asarray(jgraph.accumulate_downstream(jnp.asarray(ids), jnp.asarray(data), nodata))
    got = tgraph.accumulate_downstream(torch.as_tensor(ids), torch.as_tensor(data), nodata).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
@pytest.mark.parametrize("dtype,nodata", [(np.int32, -1), (np.float32, -9999.0),
                                          (np.float64, np.nan)])
def test_fillnodata_upstream_bitwise(d8_small, name, dtype, nodata):
    ids = _graphs(d8_small)[name]
    rng = np.random.RandomState(4)
    data = (rng.rand(ids.size) * 10 + 1).astype(dtype)
    data[rng.rand(ids.size) < 0.6] = nodata
    want = np.asarray(jgraph.fillnodata_upstream(jnp.asarray(ids), jnp.asarray(data), nodata))
    got = tgraph.fillnodata_upstream(torch.as_tensor(ids), torch.as_tensor(data), nodata).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
def test_propagate_downstream_bitwise(d8_small, name):
    ids = _graphs(d8_small)[name]
    data = np.random.RandomState(5).rand(ids.size)
    want = np.asarray(jgraph.propagate_downstream(jnp.asarray(ids), jnp.asarray(data)))
    got = tgraph.propagate_downstream(torch.as_tensor(ids), torch.as_tensor(data)).numpy()
    assert np.array_equal(got, want)


def _float_atol(ids, data):
    """2 L eps total: L the doubling rounds times the largest in-degree."""
    nup = np.bincount(ids[(ids >= 0) & (ids != np.arange(ids.size))], minlength=ids.size)
    length = tgraph._n_rounds(ids.size) * max(int(nup.max()), 1)
    return 2 * length * _EPS * float(np.abs(data).sum())


def _tree_of(ids):
    return np.asarray(jgraph.rank(jnp.asarray(ids))) >= 0


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
@pytest.mark.parametrize("nodata", [None, -9999])
@pytest.mark.parametrize("with_tree", [False, True])
def test_accumulate(d8_small, name, dtype, nodata, with_tree):
    ids = _graphs(d8_small)[name]
    rng = np.random.RandomState(6)
    data = (rng.rand(ids.size) * 100).astype(dtype)
    if nodata is not None:
        data[rng.rand(ids.size) < 0.15] = nodata
    tree = _tree_of(ids) if with_tree else None
    want = np.asarray(jgraph.accumulate(jnp.asarray(ids), jnp.asarray(data),
                                        None if tree is None else jnp.asarray(tree), nodata))
    got = tgraph.accumulate(torch.as_tensor(ids), torch.as_tensor(data),
                            None if tree is None else torch.as_tensor(tree), nodata).numpy()
    assert got.dtype == want.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=_float_atol(ids, data))
    else:
        assert np.array_equal(got, want)


def test_float_sums_repeat_their_bits(d8_small):
    ids = torch.as_tensor(_graphs(d8_small)["d8_small"])
    data = torch.as_tensor(np.random.RandomState(7).rand(ids.shape[0]))
    a = tgraph.accumulate(ids, data)
    b = tgraph.accumulate(ids, data)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    # the fixed-order scatter against a sequential one
    tgt = torch.as_tensor(np.random.RandomState(8).randint(0, 41, 500))
    vals = torch.as_tensor(np.random.RandomState(9).rand(500))
    want = np.zeros(40)
    np.add.at(want, tgt.numpy()[tgt.numpy() < 40], vals.numpy()[tgt.numpy() < 40])
    got = tgraph._sum_by_target(tgt, vals, 40).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=2 * 9 * _EPS * float(vals.sum()))


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_upstream_count_bitwise(d8_small, name, with_mask):
    ids = _graphs(d8_small)[name]
    mask = (np.random.RandomState(10).rand(ids.size) < 0.7) if with_mask else None
    want = np.asarray(jgraph.upstream_count(jnp.asarray(ids),
                                            None if mask is None else jnp.asarray(mask)))
    got = tgraph.upstream_count(torch.as_tensor(ids),
                                None if mask is None else torch.as_tensor(mask)).numpy()
    assert got.dtype == want.dtype == np.int8
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_main_upstream_bitwise(d8_small, name, dtype):
    ids = _graphs(d8_small)[name]
    # few distinct values: ties, which the lowest index wins
    upa = np.random.RandomState(11).randint(0, 3, ids.size).astype(dtype)
    want = np.asarray(jgraph.main_upstream(jnp.asarray(ids), jnp.asarray(upa)))
    got = tgraph.main_upstream(torch.as_tensor(ids), torch.as_tensor(upa)).numpy()
    assert np.array_equal(got, want)
    ds = ids[got[got >= 0]]
    assert np.all(ds == np.flatnonzero(got >= 0))  # each one drains to its cell


@pytest.mark.parametrize("name", ["d8_small", "cycle3", "cycle4"])
@pytest.mark.parametrize("how", ["min", "max", "sum"])
@pytest.mark.parametrize("dtype,nodata", [(np.int32, -1), (np.float64, -9999.0)])
def test_fillnodata_downstream(d8_small, name, how, dtype, nodata):
    ids = _graphs(d8_small)[name]
    rng = np.random.RandomState(12)
    data = (rng.rand(ids.size) * 10 + 1).astype(dtype)
    data[rng.rand(ids.size) < 0.5] = nodata
    want = np.asarray(jgraph.fillnodata_downstream(jnp.asarray(ids), jnp.asarray(data), nodata,
                                                   how=how))
    got = tgraph.fillnodata_downstream(torch.as_tensor(ids), torch.as_tensor(data), nodata,
                                       how=how).numpy()
    assert got.dtype == want.dtype
    if how == "sum" and dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=_float_atol(ids, np.where(data == nodata, 0, data)))
    else:
        assert np.array_equal(got, want)


def test_fillnodata_downstream_rejects_unknown_methods():
    ids = torch.as_tensor(_cycle_graph(3))
    with pytest.raises(ValueError, match="Unknown method"):
        tgraph.fillnodata_downstream(ids, torch.ones(ids.shape[0]), -1, how="mean")
