"""The port's downward engine against the JAX package's, on the CPU (the
kernels' plain versions; the JAX plan through its vmap path).

``TilePlan.accumulate_down``: int32 and int64 bitwise equal to the JAX plan
and to a sequential path-sum sweep; float64 within rtol 1e-12 plus
2 * n * eps * total (the port sums in another order: a difference of prefix
sums keeps their absolute error, at most about n * eps * total, on each
side). Grids: 300x260 and 260x140 (several tiles, padding, missing cells, the
gather coarse level); 256x256 with ``_COARSE_ROUTER_MIN`` lowered in both
packages (the router coarse level, kernels H1 and H0) and with
``_COARSE_SMALL_MAX`` lowered to 0 as well (the ``BigAccelPlan`` coarse
level); 256x256 whose tiles
each drain to pits of their own (no entry cells: pass D1 routed, alone). The
down indices built natively equal those replayed from the JAX plan's down
tables. The raster methods on top of it are in
``test_torch_tile_down_raster.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyflwdir_torch import dem as tdem
from pyflwdir_torch import kernels, runtime, trace
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu.ops import tile_plan as jtpm

_EPS = np.finfo(np.float64).eps


def _demo_d8(shape, seed):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    d8 = tdem.fill_depressions(z)[1]
    d8[1, 2:5] = 247  # missing cells
    return d8


def _closed_tiles(shape=(256, 256)):
    """Every cell flows east to a pit in the last column of its tile: no
    flow crosses a tile edge, so the plan has no entry cells."""
    d8 = np.ones(shape, np.uint8)
    d8[:, 127::128] = 0
    d8[5, 3:6] = 247
    return d8


def _replay(jtp):
    """The port's plan from the JAX plan's host arrays, down tables included."""
    jtp._ensure_down()
    cfg = dict(shape=jtp.shape, tile_rows=jtp.Y, far_mode=jtp.far_mode, b=jtp.b,
               R_pad=jtp.R_pad, E_pad=jtp.E_pad, F_rows=jtp.F_rows,
               has_far=jtp.has_far, has_entries=jtp.has_entries)
    dfs = jtp._coarse_dfs
    router = not isinstance(jtp.coarse, jtpm._CoarseGather)
    down = dict(tabs=jtp._down["tabs"], cd=jtp._down["cd"],
                routers=jtp.coarse.down_router_tables() if router else None)
    return ttp.TilePlan.from_stage_tables(
        jtp._tabs_np, cfg, jtp._coarse_meta, (dfs.preorder_np, dfs.pos_np, dfs.size_np),
        routers=jtp.coarse.router_tables() if router else None, down=down, device="cpu")


# name: (grid, _COARSE_ROUTER_MIN, _COARSE_SMALL_MAX, coarse level, has entries)
_GRIDS = {
    "300x260": (lambda: _demo_d8((300, 260), 21), None, None, "_CoarseGather", True),
    "260x140": (lambda: _demo_d8((260, 140), 31), None, None, "_CoarseGather", True),
    "256x256-router": (lambda: _demo_d8((256, 256), 8), 1, None, "_CoarseRouterSmall", True),
    "256x256-big": (lambda: _demo_d8((256, 256), 8), 1, 0, "BigAccelPlan", True),
    "closed-tiles": (_closed_tiles, None, None, "_CoarseGather", False),
}


@pytest.fixture(scope="module", params=list(_GRIDS))
def plans(request):
    make, router_min, small_max, coarse_kind, has_entries = _GRIDS[request.param]
    d8 = make()
    ids = td8.from_array(d8, dtype=np.int64)[0]
    new = {"_COARSE_ROUTER_MIN": router_min, "_COARSE_SMALL_MAX": small_max}
    old = {k: (getattr(jtpm, k), getattr(ttp, k)) for k in new}
    try:
        for k, v in new.items():
            if v is not None:
                setattr(jtpm, k, v)
                setattr(ttp, k, v)
        jtp = jtpm.build_tile_plan(ids, d8.shape)
        tp = ttp.build_tile_plan(ids, d8.shape, device="cpu")
    finally:
        for k, (j, t) in old.items():
            setattr(jtpm, k, j)
            setattr(ttp, k, t)
    assert type(jtp.coarse).__name__ == type(tp.coarse).__name__ == coarse_kind
    assert jtp.has_entries == tp.has_entries == has_entries
    seq = runtime.dfs_preorder(ids)[0]  # downstream cells before upstream ones
    return dict(ids=ids, shape=d8.shape, jtp=jtp, tp=tp, rtp=_replay(jtp), seq=seq)


def _sweep(plans, w):
    """Sequential path sums (float64; exact for the small integers here)."""
    return runtime.downward_sweep(plans["ids"], plans["seq"], w)


def _jax_down(jtp, x):
    """The JAX plan's ``accumulate_down``, compiled as one program with the
    plan's arrays as arguments (called eagerly, each operation compiles
    apart)."""
    return np.asarray(jax.jit(jtp.accumulate_down)(jnp.asarray(x), jtp.down_arrays()))


def _int_data(kind, n):
    rng = np.random.RandomState(5)
    return {"ones": np.ones(n, np.int32),
            "int32": rng.randint(-50, 1000, n).astype(np.int32),
            # |max| * n >= 2^31: the port accumulates in int64
            "int64_wide": rng.randint(0, 1 << 20, n).astype(np.int64),
            # path sums past 2^31: int32 wraps, the exact sum's low 32 bits
            "int32_wrap": rng.randint(0, 1 << 28, n).astype(np.int32),
            "uint8": rng.randint(0, 256, n).astype(np.uint8)}[kind]


@pytest.mark.parametrize("kind", ["ones", "int32", "int64_wide", "int32_wrap", "uint8"])
def test_accumulate_down_int_bitwise(plans, kind):
    ids, jtp, tp, rtp = plans["ids"], plans["jtp"], plans["tp"], plans["rtp"]
    data = _int_data(kind, ids.size)
    reads = trace.host_reads["acc_dtype"]
    assert kernels.acc_dtype(torch.as_tensor(data)) == (
        torch.int64 if kind == "int64_wide" else torch.int32)
    kernels.reset_launches()
    got = tp.accumulate_down(torch.as_tensor(data))
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    # only 64-bit integer data reads its range to the host
    assert trace.host_reads["acc_dtype"] - reads == (4 if kind == "int64_wide" else 0)
    assert got.dtype == torch.as_tensor(data).dtype
    if kind in ("int32_wrap", "uint8"):
        # the int64 path through the same plan, cast back to the data's dtype
        wide = tp.accumulate_down(torch.as_tensor(data, dtype=torch.int64))
        assert kind == "uint8" or int(wide.max()) >= 1 << 31
        assert torch.equal(got, wide.to(got.dtype))
    got = got.numpy()
    assert np.array_equal(got, _jax_down(jtp, data))
    # float64 path sums, exact here, to the data's width through int64
    assert np.array_equal(got, _sweep(plans, data).astype(np.int64).astype(data.dtype))
    assert np.array_equal(rtp.accumulate_down(torch.as_tensor(data)).numpy(), got)
    # missing cells pass their values through
    assert np.array_equal(got[ids < 0], data[ids < 0])


def test_accumulate_down_float64_close(plans):
    ids, jtp, tp = plans["ids"], plans["jtp"], plans["tp"]
    w = np.random.RandomState(7).rand(ids.size)
    got = tp.accumulate_down(torch.as_tensor(w))
    assert got.dtype == torch.float64
    # the same bits from run to run
    assert torch.equal(got, tp.accumulate_down(torch.as_tensor(w)))
    got = got.numpy()
    tol = dict(rtol=1e-12, atol=2 * ids.size * _EPS * w[ids >= 0].sum())
    np.testing.assert_allclose(got, _sweep(plans, w), **tol)
    if isinstance(jtp.coarse, jtpm._CoarseGather):
        # the JAX router coarse level rounds float input to float32
        np.testing.assert_allclose(got, _jax_down(jtp, w), **tol)
    assert np.array_equal(got[ids < 0], w[ids < 0])
    # float32 data comes back float32, summed in float64
    got32 = tp.accumulate_down(torch.as_tensor(w.astype(np.float32)))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), _sweep(plans, w.astype(np.float32)), rtol=1.2e-7)


def _float32_data(n, seed):
    """float32 values across the type's range: random signs, magnitudes from
    1e-30 to 1e30, zeros and subnormals among them."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.uniform(-30, 30, n)
    x[rng.rand(n) < 0.05] = 0.0
    x[rng.rand(n) < 0.02] = 1e-42
    return torch.as_tensor(x.astype(np.float32))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def test_accumulate_down_float32_is_the_float64_sum_rounded_once(plans):
    """float32 data: bit for bit the float64 sweep of the widened data,
    rounded once to float32, with no cast copy either way."""
    ids, tp = plans["ids"], plans["tp"]
    x = _float32_data(ids.size, 9)
    before = dict(trace.casts)
    got = tp.accumulate_down(x)
    assert {k: v - before.get(k, 0) for k, v in trace.casts.items()
            if v != before.get(k, 0)} == {"down.fused": 1}
    assert got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(tp.accumulate_down(x.double()).to(torch.float32)))
    assert torch.equal(_bits(got[ids < 0]), _bits(x[ids < 0]))


def test_plain_down_passes_sum_float32_in_float64(plans):
    """The plain T3 and T4 widen float32 data and sum it in float64: the
    float64 z and pk of the widened data, bit for bit, and results rounded
    once from the float64 ones."""
    tp = plans["tp"]
    d = tp.down_arrays()
    x32 = _float32_data(tp.shape[0] * tp.shape[1], 10)
    x64 = x32.double()
    d1 = (d["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
    z, pk = kernels.tile_down_a_plain(x32, *d1, None, tp.shape, False)
    z64, pk64 = kernels.tile_down_a_plain(x64, *d1, None, tp.shape, False)
    assert z.dtype == pk.dtype == torch.float64
    assert torch.equal(_bits(z), _bits(z64)) and torch.equal(_bits(pk), _bits(pk64))
    routed, _ = kernels.tile_down_a_plain(x32, *d1, d["rout"], tp.shape, True)
    routed64, _ = kernels.tile_down_a_plain(x64, *d1, d["rout"], tp.shape, True)
    assert routed.dtype == torch.float32
    assert torch.equal(_bits(routed), _bits(routed64.to(torch.float32)))
    A = torch.as_tensor(np.random.RandomState(11).standard_normal((tp.NT, tp.R_pad)) * 1e20)
    fin = kernels.tile_down_fin_plain(x32, z, A, d["tree_of"], d["rout"], tp.shape)
    fin64 = kernels.tile_down_fin_plain(x64, z64, A, d["tree_of"], d["rout"], tp.shape)
    assert fin.dtype == torch.float32
    assert torch.equal(_bits(fin), _bits(fin64.to(torch.float32)))


def test_accumulate_down_is_the_transpose_of_accumulate(plans):
    ids, tp = plans["ids"], plans["tp"]
    rng = np.random.RandomState(5)
    valid = ids >= 0
    x = np.where(valid, rng.randint(0, 9, ids.size), 0).astype(np.int64)
    y = np.where(valid, rng.randint(0, 9, ids.size), 0).astype(np.int64)
    Sx = tp.accumulate(torch.as_tensor(x)).numpy()
    STy = tp.accumulate_down(torch.as_tensor(y)).numpy()
    assert np.dot(Sx, y) == np.dot(x, STy)


def test_down_indices_equal_the_replayed_jax_tables(plans):
    tp, rtp = plans["tp"], plans["rtp"]
    tp._ensure_down()
    rtp._ensure_down()
    assert set(tp.down_idx) == set(rtp.down_idx) == {
        "es", "g_last", "g_prev", "n_tree", "ent_slot", "tree_of"}
    for k in tp.down_idx:
        assert tp.down_idx[k].dtype == rtp.down_idx[k].dtype == np.int32, k
        assert np.array_equal(tp.down_idx[k], rtp.down_idx[k]), k
    assert tp.down_idx["ent_slot"].shape == (tp.NT, tp.E_pad)
    # each real entry's slot is where ent_idx first counts it
    es, ei = tp.down_idx["ent_slot"], tp.idx["ent_idx"]
    t, j = np.nonzero(es >= 0)
    assert np.array_equal(ei[t, es[t, j]], j)
    assert set(tp.coarse.down) == set(rtp.coarse.down) == {
        "es_in", "g_last", "g_prev", "win_next", "rev", "fin"}
    for k in tp.coarse.down:
        assert np.array_equal(tp.coarse.down[k], rtp.coarse.down[k]), k


def test_dispatch_follows_the_jax_plan(plans, monkeypatch):
    """Raw D1, the coarse level and D2 where the plan has entry cells; else
    the routed D1 alone."""
    tp = plans["tp"]
    calls = []
    for name in ("tile_down_a", "tile_down_fin"):
        real = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _r=real, _n=name: (
            calls.append((_n, a[-1]) if _n == "tile_down_a" else (_n,)) or _r(*a)))
    coarse_calls = []
    real_cd = type(tp.coarse).accumulate_down
    monkeypatch.setattr(type(tp.coarse), "accumulate_down",
                        lambda self, pkf: coarse_calls.append(pkf.numel()) or real_cd(self, pkf))
    tp.accumulate_down(torch.ones(tp.shape[0] * tp.shape[1], dtype=torch.int32))
    if tp.has_entries:
        assert calls == [("tile_down_a", False), ("tile_down_fin",)]
        assert coarse_calls == [tp.NT * tp.E_pad]
    else:
        assert calls == [("tile_down_a", True)] and coarse_calls == []
        assert tp.E_pad == 0


def test_a_plan_loaded_without_down_tables_raises(plans):
    jtp = plans["jtp"]
    cfg = dict(shape=jtp.shape, tile_rows=jtp.Y, far_mode=jtp.far_mode, b=jtp.b,
               R_pad=jtp.R_pad, E_pad=jtp.E_pad, F_rows=jtp.F_rows,
               has_far=jtp.has_far, has_entries=jtp.has_entries)
    dfs = jtp._coarse_dfs
    routers = None if isinstance(jtp.coarse, jtpm._CoarseGather) else jtp.coarse.router_tables()
    tp = ttp.TilePlan.from_stage_tables(
        jtp._tabs_np, cfg, jtp._coarse_meta, (dfs.preorder_np, dfs.pos_np, dfs.size_np),
        routers=routers, device="cpu")
    with pytest.raises(RuntimeError, match="downward"):
        tp.accumulate_down(torch.ones(jtp.shape[0] * jtp.shape[1], dtype=torch.int32))


def test_the_three_coarse_levels_agree(monkeypatch):
    """One grid through the port's gather, single-chunk and BigAccelPlan
    coarse levels: upward and downward bitwise equal, int32 and int64."""
    d8 = _demo_d8((256, 256), 8)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    tps = {}
    for kind, (router_min, small_max) in (("_CoarseGather", (200_000, 1_870_000)),
                                          ("_CoarseRouterSmall", (1, 1_870_000)),
                                          ("BigAccelPlan", (1, 0))):
        monkeypatch.setattr(ttp, "_COARSE_ROUTER_MIN", router_min)
        monkeypatch.setattr(ttp, "_COARSE_SMALL_MAX", small_max)
        tps[kind] = ttp.build_tile_plan(ids, d8.shape, device="cpu")
        assert type(tps[kind].coarse).__name__ == kind
    big = tps["BigAccelPlan"].coarse
    assert big.slot_mode and big.n_pad == 1 << 21 and big._n_down(0) == big.n_pad
    for kind in ("int32", "int64_wide"):
        x = torch.as_tensor(_int_data(kind, ids.size))
        up = tps["_CoarseGather"].accumulate(x)
        down = tps["_CoarseGather"].accumulate_down(x)
        for name in ("_CoarseRouterSmall", "BigAccelPlan"):
            assert torch.equal(tps[name].accumulate(x), up), (name, kind)
            assert torch.equal(tps[name].accumulate_down(x), down), (name, kind)
    w = torch.as_tensor(np.random.RandomState(7).rand(ids.size))
    tol = dict(rtol=1e-12, atol=2 * ids.size * _EPS * float(w.sum()))
    np.testing.assert_allclose(tps["BigAccelPlan"].accumulate(w).numpy(),
                               tps["_CoarseGather"].accumulate(w).numpy(), **tol)
    np.testing.assert_allclose(tps["BigAccelPlan"].accumulate_down(w).numpy(),
                               tps["_CoarseGather"].accumulate_down(w).numpy(), **tol)
