"""Port BigAccelPlan against the JAX package's, on the CPU (the kernels'
plain versions).

Default mode, a 256x384 D8 graph (one JAX plan, coloured once per module):
the same decisions; int32 accumulation bitwise equal to the JAX plan and to
the DFS plan; float data within the JAX tests' own bounds of the JAX plan
(rtol 1e-4, atol 4e-6 * scale: it sums a double-single float32 pair) and,
summed in float64 in another order than the DFS plan, within rtol 1e-12 plus
2 * n_pad * eps * total of it; the indices replayed from the JAX plan's
``router_tables()`` equal the natively composed ones. A 1504x1504 graph
(G1 = 2) runs through the port alone, with and without far intervals. Then
``build_accel_plan`` and ``Flwdir._accumulate_dev`` dispatch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyflwdir_torch
from pyflwdir_torch import dem as tdem
from pyflwdir_torch import kernels, trace
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import accel as taccel
from pyflwdir_torch.ops import accel_big as tbig
from pyflwdir_torch.ops import plan as tplan
from pyflwdir_tpu.ops import accel_big as jbig
from pyflwdir_tpu.ops import plan as jplan

_EPS = np.finfo(np.float64).eps
_CHUNK = 1 << 21


def _demo_d8(shape, seed=7):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    d8 = tdem.fill_depressions(z)[1]
    d8[1, 2:5] = 247  # missing cells
    return d8


def _jax_accumulate(jp, x):
    """The JAX plan's ``accumulate``, compiled as one program with the
    plan's arrays as arguments (called eagerly, each operation compiles
    apart)."""
    return np.asarray(jax.jit(jp.accumulate)(jnp.asarray(x), jp.arrays()))


@pytest.fixture(scope="module")
def plans():
    ids = td8.from_array(_demo_d8((256, 384)), dtype=np.int64)[0]
    jp = jbig.build_big_accel_plan(ids, jplan.build_plan(ids, fast=False))
    dfs = tplan.build_plan(ids, device="cpu")
    tp = tbig.build_big_accel_plan(ids, dfs, device="cpu")
    rp = tbig.BigAccelPlan(dfs, ids, routers=jp.router_tables())
    return dict(ids=ids, jp=jp, dfs=dfs, tp=tp, rp=rp)


def test_decisions_equal(plans):
    jp, tp, rp = plans["jp"], plans["tp"], plans["rp"]
    assert type(tp).__name__ == type(jp).__name__ == "BigAccelPlan"
    for f in ("n_cells", "n_tree", "n_in", "n_out", "n_pad", "ok", "slot_mode", "has_far"):
        assert getattr(tp, f) == getattr(rp, f) == getattr(jp, f), f
    assert tp.G1 == jp.r_in.G1 == 1 and jp.has_far and not jp.slot_mode


def test_replayed_indices_equal_the_native_ones(plans):
    jp, dfs, tp, rp = plans["jp"], plans["dfs"], plans["tp"], plans["rp"]
    for k in ("src_in", "near_end", "src_out", "far_end"):
        assert getattr(tp, k).dtype == getattr(rp, k).dtype == np.int32, k
        assert np.array_equal(getattr(tp, k), getattr(rp, k)), k
    # tables from before r_exp existed gather the distinct ends instead
    old = {k: v for k, v in jp.router_tables().items() if k != "r_exp"}
    op = tbig.BigAccelPlan(dfs, None, routers=old)
    assert np.array_equal(op.far_end, tp.far_end)
    # a far cell reads its own interval end; off-tree cells are marked
    far = tp.far_end >= 0
    assert far.any()
    assert np.array_equal(tp.far_end[far], (dfs.pos_np + dfs.size_np - 1)[far])
    assert np.array_equal(tp.far_end == -2, dfs.pos_np < 0)
    assert np.array_equal(far, dfs.size_np - 1 >= 128)
    # against the JAX plan's lane and mask tables
    near = tp.near_end >= 0
    assert np.array_equal(near, np.asarray(jp.near_sel).ravel())
    row_end = (np.arange(tp.n_pad) // 128 + np.asarray(jp.sel_next).ravel()) * 128 \
        + np.asarray(jp.idx_near).ravel()
    assert np.array_equal(tp.near_end[near], row_end[near])
    assert np.array_equal(tp.far_end != -2, np.asarray(jp.tree_mask).ravel()[: tp.n_out])


@pytest.mark.parametrize("which", ["tp", "rp"])
def test_composed_kernel_indices(plans, which):
    """H2's interval end of every tree slot, near and far, and H3's source:
    ``src_out`` on the tree, -1 off it; native and replayed alike."""
    dfs, p = plans["dfs"], plans[which]
    on = dfs.pos_np >= 0
    want = np.full(p.n_pad, -1)
    want[dfs.pos_np[on]] = (dfs.pos_np + dfs.size_np - 1)[on]
    assert np.array_equal(p._t["end"].numpy(), want)
    assert np.array_equal(p._t["src_res"].numpy(), np.where(on, p.src_out[: p.n_out], -1))
    assert np.array_equal(p._t["src_res"].numpy()[on], dfs.pos_np[on])


@pytest.mark.parametrize("kind", ["ones", "int32", "bool", "int32_wrap", "uint8"])
def test_accumulate_int_bitwise(plans, kind):
    ids, jp, dfs, tp, rp = (plans[k] for k in ("ids", "jp", "dfs", "tp", "rp"))
    rng = np.random.RandomState(5)
    data = {"ones": np.ones(ids.size, np.int32),
            "int32": rng.randint(-50, 1000, ids.size).astype(np.int32),
            "bool": rng.rand(ids.size) < 0.3,
            # sums past 2^31: int32 wraps, the exact sum's low 32 bits
            "int32_wrap": rng.randint(0, 1 << 28, ids.size).astype(np.int32),
            "uint8": rng.randint(0, 256, ids.size).astype(np.uint8)}[kind]
    reads = trace.host_reads["acc_dtype"]
    assert kernels.acc_dtype(torch.as_tensor(data)) == torch.int32
    kernels.reset_launches()
    got = tp.accumulate(torch.as_tensor(data))
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert trace.host_reads["acc_dtype"] == reads  # no range read
    assert got.dtype == torch.as_tensor(data).dtype
    if kind == "int32_wrap":
        wide = tplan.accumulate_planned(dfs, torch.as_tensor(data, dtype=torch.int64))
        assert int(wide.max()) >= 1 << 31
        assert torch.equal(got, wide.to(torch.int32))
    want = _jax_accumulate(jp, data)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(rp.accumulate(torch.as_tensor(data)), got)
    if kind != "bool":
        assert torch.equal(got, tplan.accumulate_planned(dfs, torch.as_tensor(data)))
    # off-tree cells pass their values through
    assert np.array_equal(got.numpy()[ids < 0], data[ids < 0])


def test_accumulate_int64_where_int32_would_overflow(plans):
    ids, dfs, tp = plans["ids"], plans["dfs"], plans["tp"]
    data = np.random.RandomState(6).randint(0, 1 << 20, ids.size).astype(np.int64)
    x = torch.as_tensor(data)
    assert kernels.acc_dtype(x) == torch.int64  # |max| * n >= 2^31
    assert kernels.acc_dtype(torch.ones(ids.size, dtype=torch.int64)) == torch.int32
    got = tp.accumulate(x)
    assert got.dtype == torch.int64 and int(got.max()) >= 1 << 31
    assert torch.equal(got, tplan.accumulate_planned(dfs, x))


def test_accumulate_float_close(plans):
    ids, jp, dfs, tp = plans["ids"], plans["jp"], plans["dfs"], plans["tp"]
    w = np.random.RandomState(3).rand(ids.size)
    got = tp.accumulate(torch.as_tensor(w))
    assert got.dtype == torch.float64
    want = tplan.accumulate_planned(dfs, torch.as_tensor(w)).numpy()
    total = w[ids >= 0].sum()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=2 * tp.n_pad * _EPS * total)
    assert np.array_equal(got.numpy()[ids < 0], w[ids < 0])
    # float32 data comes back float32, summed in float64; the JAX plan sums
    # a double-single float32 pair
    w32 = w.astype(np.float32)
    got32 = tp.accumulate(torch.as_tensor(w32))
    assert got32.dtype == torch.float32
    want32 = _jax_accumulate(jp, w32)
    scale = max(np.abs(want32).max(), 1.0)
    np.testing.assert_allclose(got32.numpy(), want32, rtol=1e-4, atol=4e-6 * scale)


def test_accumulate_checks_the_size(plans):
    with pytest.raises(ValueError, match="must hold"):
        plans["tp"].accumulate(torch.ones(7, dtype=torch.int32))
    # tables of one chunk do not fit a graph of two
    n = _CHUNK + 1
    chain = tplan.build_plan(np.minimum(np.arange(n) + 1, n - 1), device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        tbig.BigAccelPlan(chain, None, routers=plans["jp"].router_tables())


def test_down_sort_sigmas_equal_the_jax_ones(plans):
    dfs = plans["dfs"]
    pre, size = dfs.preorder_np, dfs.size_np
    n_pad = -(-pre.size // 16384) * 16384
    got = tbig.down_sort_sigmas(pre, size, n_pad)
    want = jbig.down_sort_sigmas(pre, size, n_pad)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    masks = tbig.down_sort_sigmas(pre, size, n_pad, need_sigmas=False)
    assert masks[:3] == (None, None, None)
    assert np.array_equal(masks[3], want[3]) and np.array_equal(masks[4], want[4])


# ---------------------------------------------------------------------------
# two router chunks, through the port alone (the JAX build would colour 2^22
# elements per router)
# ---------------------------------------------------------------------------
def _short_runs(shape, run):
    """Rows flowing east into a pit every ``run`` columns: no subtree spans
    128 slots, so the plan has no far intervals."""
    d8 = np.ones(shape, np.uint8)
    d8[:, run - 1 :: run] = 0
    d8[:, -1] = 0
    return d8


@pytest.mark.parametrize("kind", ["far", "no-far"])
def test_two_chunks_against_the_dfs_plan(kind):
    side = 1504  # 2.26 M cells: G1 = 2
    d8 = _demo_d8((side, side), 17) if kind == "far" else _short_runs((side, side), 100)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    dfs = tplan.build_plan(ids, device="cpu")
    tp = taccel.build_accel_plan(ids, dfs, device="cpu")
    assert isinstance(tp, tbig.BigAccelPlan) and tp.n_pad == 2 * _CHUNK and tp.G1 == 2
    assert tp.has_far == (kind == "far")
    rng = np.random.RandomState(3)
    ones = torch.ones(ids.size, dtype=torch.int32)
    got = tp.accumulate(ones)
    assert torch.equal(got, tplan.accumulate_planned(dfs, ones))
    pits = np.nonzero(ids == np.arange(ids.size))[0]
    assert int(got.numpy()[pits].sum()) == int((ids >= 0).sum())  # mass conservation
    x = torch.as_tensor(rng.randint(-9, 99, ids.size).astype(np.int32))
    assert torch.equal(tp.accumulate(x), tplan.accumulate_planned(dfs, x))
    w = rng.rand(ids.size)
    want = tplan.accumulate_planned(dfs, torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(tp.accumulate(torch.as_tensor(w)).numpy(), want, rtol=1e-12,
                               atol=2 * tp.n_pad * _EPS * w[ids >= 0].sum())


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_build_returns_none_past_the_big_plan(monkeypatch):
    monkeypatch.setattr(tbig, "_CHUNK", 64)  # capacity 128 * 64 slots
    # a chain: its far intervals share one end, which the single-chunk plan
    # does not take either
    ids = np.minimum(np.arange(10_000) + 1, 9_999)
    assert taccel.build_accel_plan(ids, device="cpu") is None


@pytest.mark.parametrize("engine", ["AccelPlan", "BigAccelPlan", "None"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64])
def test_flwdir_dispatch(monkeypatch, d8_small, engine, dtype):
    """``Flwdir._accumulate_dev`` as the JAX package's: the 2^24 guard only
    for the float32 single-chunk plan; a BigAccelPlan takes every dtype; no
    plan: the DFS plan."""
    ids = td8.from_array(d8_small, dtype=np.int64)[0]
    calls = []
    if engine == "BigAccelPlan":
        monkeypatch.setattr(taccel, "build_accel_plan", lambda ids_, dfs, device=None:
                            tbig.build_big_accel_plan(ids_, dfs, device=device))
    elif engine == "None":
        monkeypatch.setattr(taccel, "build_accel_plan", lambda *a, **k: None)
    for cls in (taccel.AccelPlan, tbig.BigAccelPlan):
        real = cls.accumulate
        monkeypatch.setattr(cls, "accumulate", lambda self, data, _r=real, _n=cls.__name__:
                            calls.append(_n) or _r(self, data))
    fl = pyflwdir_torch.Flwdir(ids, device="cpu")
    rng = np.random.RandomState(9)
    small = (rng.rand(ids.size) * 3).astype(dtype)
    wide = (rng.rand(ids.size) * 3).astype(dtype) + (1 << 22)  # |max| * n >= 2^24
    dfs = tplan.build_plan(ids, device="cpu")
    is_int = np.dtype(dtype).kind == "i"
    for data, is_wide in ((small, False), (wide, True)):
        calls.clear()
        got = fl._accumulate_dev(torch.as_tensor(data))
        assert got.dtype == torch.as_tensor(data).dtype
        want = tplan.accumulate_planned(dfs, torch.as_tensor(data))
        if is_int:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
        took = {"AccelPlan": ["AccelPlan"] if is_int and not is_wide else [],
                "BigAccelPlan": ["BigAccelPlan"], "None": []}[engine]
        assert calls == took, (engine, dtype, is_wide)
    assert type(fl._accel()).__name__ == ("NoneType" if engine == "None" else engine)
