"""Port DFS plan against the JAX package's: equal preorder/pos/size, and
planned accumulation bitwise for integer data, within rtol 1e-12 for float64.

The two frameworks sum the float64 prefix in different orders, and an
interval difference ``c[end] - c[start-1]`` keeps the absolute rounding
error of its operands, a few ulps of the running total. So the float
comparison also allows an absolute ``1e-14 * total`` (about 45 ulps)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyflwdir_torch import dem as tdem
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import plan as tplan
from pyflwdir_tpu.ops import plan as jplan


def _demo_d8(shape, seed=7):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    return tdem.fill_depressions(z)[1]


@pytest.fixture(scope="module", params=["small", "64x96", "256x384"])
def idxs_ds(request, d8_small):
    d8 = {"small": lambda: d8_small, "64x96": lambda: _demo_d8((64, 96)),
          "256x384": lambda: _demo_d8((256, 384))}[request.param]()
    return td8.from_array(d8, dtype=np.int64)[0]


def test_build_plan_equal(idxs_ds):
    j = jplan.build_plan(idxs_ds, fast=False)
    t = tplan.build_plan(idxs_ds, device="cpu")
    assert t.n_tree == j.n_tree
    assert np.array_equal(t.preorder_np, j.preorder_np)
    assert np.array_equal(t.pos_np, j.pos_np)
    assert np.array_equal(t.size_np, j.size_np)
    assert t.preorder.dtype == torch.int64


@pytest.mark.parametrize("fn", ["accumulate_planned", "accumulate_planned_fast"])
def test_accumulate_int_bitwise(idxs_ds, fn):
    rng = np.random.RandomState(3)
    data = rng.randint(0, 1000, idxs_ds.size).astype(np.int64)
    j = np.asarray(getattr(jplan, fn)(jplan.build_plan(idxs_ds), jnp.asarray(data)))
    t = getattr(tplan, fn)(tplan.build_plan(idxs_ds, device="cpu"), torch.as_tensor(data))
    assert t.dtype == torch.int64
    assert np.array_equal(t.numpy(), j)


@pytest.mark.parametrize("fn", ["accumulate_planned", "accumulate_planned_fast"])
def test_accumulate_float64_close(idxs_ds, fn):
    rng = np.random.RandomState(4)
    data = rng.rand(idxs_ds.size)
    j = np.asarray(getattr(jplan, fn)(jplan.build_plan(idxs_ds), jnp.asarray(data)))
    t = getattr(tplan, fn)(tplan.build_plan(idxs_ds, device="cpu"), torch.as_tensor(data))
    assert t.dtype == torch.float64
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-12, atol=1e-14 * data.sum())


def test_accumulate_fast_leaves_input(idxs_ds):
    data = torch.ones(idxs_ds.size, dtype=torch.float64)
    tplan.accumulate_planned_fast(tplan.build_plan(idxs_ds, device="cpu"), data)
    assert bool((data == 1).all())
