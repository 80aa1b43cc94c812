"""Port pointer-doubling primitives against the JAX package's: rank, roots,
reach, the path reductions, downstream accumulation and nodata filling
bitwise equal (the same rounds combine the same pairs), on grids and on
graphs with cycles."""

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
