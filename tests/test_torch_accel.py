"""Port AccelPlan against the JAX package's: the same host tables and
dispatch rule, and integer accumulation bitwise equal to the JAX unfused
router path and to the DFS plan. (The JAX fused path runs only on a TPU,
so the kernels' plain versions are held against the unfused one.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyflwdir_torch import dem as tdem
from pyflwdir_torch import kernels
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import accel as taccel
from pyflwdir_torch.ops import plan as tplan
from pyflwdir_tpu.ops import accel as jaccel
from pyflwdir_tpu.ops import plan as jplan


def _demo_d8(shape, seed=7):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    return tdem.fill_depressions(z)[1]


@pytest.fixture(scope="module", params=["small", "64x96", "256x384"])
def plans(request, d8_small):
    d8 = {"small": lambda: d8_small, "64x96": lambda: _demo_d8((64, 96)),
          "256x384": lambda: _demo_d8((256, 384))}[request.param]()
    ids = td8.from_array(d8, dtype=np.int64)[0]
    jp = jaccel.build_accel_plan(ids, jplan.build_plan(ids, fast=False))
    tp = taccel.build_accel_plan(ids, device="cpu")
    return ids, jp, tp


def test_plan_fields_equal(plans):
    _, jp, tp = plans
    assert isinstance(jp, jaccel.AccelPlan) and jp.ok and tp.ok
    for f in ("G", "n_pad", "b", "has_far", "n_cells", "n_tree"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("near_mask", "idx_near", "sel_next", "tree_mask"):
        assert np.array_equal(getattr(tp, f), np.asarray(getattr(jp, f)).ravel()), f
    if jp.has_far:
        assert np.array_equal(tp.far_mask, np.asarray(jp.far_mask).ravel())


def test_bijections_equal(plans):
    _, jp, tp = plans
    ar = np.arange(jp.n_pad, dtype=np.int64).reshape(-1, 128)
    routers = [("sig_in", "r_in"), ("sig_out", "r_out")]
    if jp.has_far:
        routers += [("sig_exp", "r_exp"), ("sig_far", "r_far")]
    for mine, theirs in routers:
        want = getattr(jp, theirs).apply_np(ar).ravel()
        assert np.array_equal(getattr(tp, mine), want), mine
    assert np.array_equal(tp._t["src_in"].numpy(), tp.sig_in)
    # H3 reads sig_out on the tree and -1 off it
    on = tp.tree_mask[: tp.n_cells]
    assert np.array_equal(tp._t["src_res"].numpy(), np.where(on, tp.sig_out[: tp.n_cells], -1))


def test_composed_far_end(plans):
    ids, _, tp = plans
    dfs = tplan.build_plan(ids, device="cpu")
    fe = tp.far_end
    far = fe >= 0
    # a far cell reads its own interval end, pos + size - 1
    assert np.array_equal(fe[far], (dfs.pos_np + dfs.size_np - 1)[far])
    assert np.array_equal(fe == -2, dfs.pos_np < 0)


def test_composed_end(plans):
    ids, _, tp = plans
    dfs = tplan.build_plan(ids, device="cpu")
    # H2 reads every tree slot's interval end pos + size - 1, near and far;
    # padding slots -1
    on = dfs.pos_np >= 0
    want = np.full(tp.n_pad, -1)
    want[dfs.pos_np[on]] = (dfs.pos_np + dfs.size_np - 1)[on]
    assert np.array_equal(tp._t["end"].numpy(), want)
    assert (want[: tp.n_tree] >= np.arange(tp.n_tree) + 128).any() == tp.has_far


def test_accumulate_ones_bitwise(plans):
    ids, jp, tp = plans
    ones = np.ones(ids.size, dtype=np.int32)
    want_router = np.asarray(jp.accumulate(jnp.asarray(ones)))
    want_plan = np.asarray(jplan.accumulate_planned(jplan.build_plan(ids), jnp.asarray(ones)))
    kernels.reset_launches()
    got = tp.accumulate(torch.as_tensor(ones))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want_router)
    assert np.array_equal(got.numpy(), want_plan)
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions


def test_accumulate_random_int_bitwise(plans):
    ids, jp, tp = plans
    rng = np.random.RandomState(5)
    data = rng.randint(0, 100, ids.size).astype(np.int64)
    want = np.asarray(jp.accumulate(jnp.asarray(data)))
    got = tp.accumulate(torch.as_tensor(data)).numpy()
    assert np.array_equal(got, want)


def test_kernel_plain_versions_match_unfused_steps(plans):
    ids, jp, tp = plans
    rng = np.random.RandomState(6)
    x = rng.randint(0, 50, ids.size).astype(np.float32)
    xt = torch.as_tensor(x)
    c = kernels.accel_in_scan(xt, tp._t["src_in"])
    xpad = np.zeros(jp.n_pad, np.float32)
    xpad[: x.size] = x
    want_c = np.asarray(jp._cumsum2(jp.r_in.apply(jnp.asarray(xpad.reshape(-1, 128)))))
    assert np.array_equal(c.numpy(), want_c.ravel())


def test_chain_graph_falls_outside_the_slice():
    # a 400-cell chain: >128 far intervals share one end, so it falls outside
    # the single-chunk plan and both packages take their BigAccelPlan
    from pyflwdir_torch.ops.accel_big import BigAccelPlan

    n = 400
    ids = np.minimum(np.arange(n) + 1, n - 1)
    assert not jaccel.AccelPlan(jplan.build_plan(ids, fast=False), ids).ok
    assert not taccel.AccelPlan(tplan.build_plan(ids, device="cpu"), device="cpu").ok
    tp = taccel.build_accel_plan(ids, device="cpu")
    assert isinstance(tp, BigAccelPlan) and tp.ok and tp.n_pad == 1 << 21 and tp.has_far
    jp = jaccel.build_accel_plan(ids, jplan.build_plan(ids, fast=False))
    assert type(jp).__name__ == "BigAccelPlan" and jp.n_pad == tp.n_pad
    ones = np.ones(n, dtype=np.int32)
    got = tp.accumulate(torch.as_tensor(ones)).numpy()
    assert np.array_equal(got, np.asarray(jp.accumulate(jnp.asarray(ones))))
    assert np.array_equal(got, np.arange(1, n + 1))
