"""Port pointer-doubling primitives against the JAX package's: rank, roots
and reach bitwise equal, on grids and on graphs with cycles."""

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
