"""Port TilePlan against the JAX package's: the same build decisions, the
composed indices equal to a replay of the JAX plan's stage tables, and
accumulation bitwise equal (integers) to the JAX fused and unfused paths and
to the DFS plan, on the CPU (the kernels' plain versions).

Grids: 300x200 (several tiles, padding, missing cells, the gather coarse
level); 256x256 with ``_COARSE_ROUTER_MIN`` lowered in both packages (the
router coarse level, kernels H0-H3) and, with ``_COARSE_SMALL_MAX`` lowered
to 0 as well, the ``BigAccelPlan`` coarse level; a 256x128 serpentine chain
(the packed far mode).

Float data: the port sums float64 in another order than the JAX package;
an interval difference keeps the absolute error of the prefix sums, at most
about n * eps * total for any order, on each side: rtol 1e-12 plus
2 * n * eps * total. Held against the float64 DFS plan, and against the JAX
tile plan where its coarse level runs float64 too (``_CoarseGather``; its
router coarse level rounds float input to float32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import dem as tdem
from pyflwdir_torch import kernels, trace
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import accel_big as tbig
from pyflwdir_torch.ops import plan as tplan
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu.ops import accel_big as jbig
from pyflwdir_tpu.ops import plan as jplan
from pyflwdir_tpu.ops import tile_plan as jtpm

# the suite runs in several worker processes at once (pytest-xdist), each
# collecting every module: torch's thread pool in each of them only
# contends for the same cores
torch.set_num_threads(1)

_EPS = np.finfo(np.float64).eps


def _demo_d8(shape, seed):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    d8 = tdem.fill_depressions(z)[1]
    d8[1, 2:5] = 247  # missing cells
    return d8


def _serpentine(H=256, W=128):
    ser = np.zeros((H, W), np.uint8)
    for r in range(H):
        ser[r, :] = 16 if r % 2 else 1
        ser[r, W - 1 if r % 2 == 0 else 0] = 4
    ser[H - 1, W - 1 if (H - 1) % 2 == 0 else 0] = 0
    return ser


def _replay(jtp):
    """The port's plan from the JAX plan's host arrays."""
    cfg = dict(shape=jtp.shape, tile_rows=jtp.Y, far_mode=jtp.far_mode, b=jtp.b,
               R_pad=jtp.R_pad, E_pad=jtp.E_pad, F_rows=jtp.F_rows,
               has_far=jtp.has_far, has_entries=jtp.has_entries)
    dfs = jtp._coarse_dfs
    routers = None if isinstance(jtp.coarse, jtpm._CoarseGather) else jtp.coarse.router_tables()
    return ttp.TilePlan.from_stage_tables(
        jtp._tabs_np, cfg, jtp._coarse_meta, (dfs.preorder_np, dfs.pos_np, dfs.size_np),
        routers=routers, device="cpu")


def _jax_up(jtp, x):
    """The JAX plan's ``accumulate``, compiled as one program with the
    plan's arrays as arguments (called eagerly, each operation compiles
    apart)."""
    return np.asarray(jax.jit(jtp.accumulate)(jnp.asarray(x), jtp.arrays()))


def _jit_banded(jtp):
    """Compile the JAX plan's banded sweep, ``accumulate_banded``, pass by
    pass with ``jax.jit``: its per-band passes (``_pass_a_tiles``,
    ``_pass_c_tiles``, one program for each ``cfg``) and its coarse level's
    ``accumulate``. The same functions on the same arrays; called eagerly,
    each of their operations compiles apart, ten times slower on the CPU."""
    cache = {}

    def jitted(name):
        f = getattr(type(jtp), name)

        def call(*args):
            cfg = args[-1]
            key = (name, tuple(sorted((k, repr(v)) for k, v in cfg.items())))
            if key not in cache:
                cache[key] = jax.jit(lambda *a: f(jtp, *a, cfg))
            return cache[key](*args[:-1])
        return call

    jtp._pass_a_tiles = jitted("_pass_a_tiles")
    jtp._pass_c_tiles = jitted("_pass_c_tiles")
    jtp.coarse.accumulate = jax.jit(jtp.coarse.accumulate)
    return jtp


class _Thresholds:
    """Both packages' coarse backend thresholds, patched alike and restored."""

    def __init__(self, router_min=None, small_max=None):
        self.new = {"_COARSE_ROUTER_MIN": router_min, "_COARSE_SMALL_MAX": small_max}

    def __enter__(self):
        self.old = {k: (getattr(jtpm, k), getattr(ttp, k)) for k in self.new}
        for k, v in self.new.items():
            if v is not None:
                setattr(jtpm, k, v)
                setattr(ttp, k, v)

    def __exit__(self, *exc):
        for k, (j, t) in self.old.items():
            setattr(jtpm, k, j)
            setattr(ttp, k, t)


# name: (grid, _COARSE_ROUTER_MIN, _COARSE_SMALL_MAX, coarse level, far mode)
_GRIDS = {
    "300x200": (lambda: _demo_d8((300, 200), 3), None, None, "_CoarseGather", "router"),
    "256x256-router": (lambda: _demo_d8((256, 256), 5), 1, None, "_CoarseRouterSmall",
                       "router"),
    "256x256-big": (lambda: _demo_d8((256, 256), 5), 1, 0, "BigAccelPlan", "router"),
    "serpentine": (_serpentine, None, None, "_CoarseGather", "packed"),
}


def _plans(request):
    make, router_min, small_max, coarse_kind, far_mode = _GRIDS[request.param]
    d8 = make()
    ids = td8.from_array(d8, dtype=np.int64)[0]
    with _Thresholds(router_min, small_max):
        jtp = jtpm.build_tile_plan(ids, d8.shape)
        tp = ttp.build_tile_plan(ids, d8.shape, device="cpu")
    assert type(jtp.coarse).__name__ == type(tp.coarse).__name__ == coarse_kind
    assert jtp.far_mode == tp.far_mode == far_mode
    return dict(ids=ids, shape=d8.shape, jtp=jtp, tp=tp, rtp=_replay(jtp))


def plans_fixture(grids):
    """The module fixture ``plans`` over ``grids`` (names of ``_GRIDS``),
    each built in both packages once a module: the gather-level grids here,
    the router coarse levels in ``test_torch_tile_plan_router.py``, so that
    parallel workers share them out."""
    return pytest.fixture(scope="module", name="plans", params=list(grids))(_plans)


plans = plans_fixture(("300x200", "serpentine"))


def _jax_unfused(jtp, x):
    """The JAX plan's unfused vmap path: pass A, coarse level, pass C,
    compiled as one program with the plan's arrays as arguments."""
    H, W = jtp.shape
    Hp, Wp = jtp.pshape
    cfg = jtp._acc_cfg(x.dtype)

    def run(x, arrs):
        xg = jnp.pad(x.reshape(H, W).astype(cfg["acc"]), ((0, Hp - H), (0, Wp - W)))
        ex = jtp._pass_a(xg, arrs, cfg)
        entv = jtp.coarse.accumulate(ex.reshape(-1), arrs["coarse"])
        pad = jtp.NT * jtp.E_rows * 128 - entv.shape[0]
        entv = jnp.concatenate([entv, jnp.zeros(max(pad, 0), entv.dtype)])
        entv = entv.reshape(jtp.NT, jtp.E_rows, 128)
        return jtp._pass_c(xg, entv, arrs, cfg)[:H, :W]

    out = jax.jit(run)(jnp.asarray(x), jtp.arrays())
    return np.asarray(out).reshape(-1).astype(x.dtype)


def test_build_decisions_equal(plans):
    jtp, tp, rtp = plans["jtp"], plans["tp"], plans["rtp"]
    for f in ("shape", "pshape", "Y", "grid", "NT", "far_mode", "b", "R_pad", "E_pad",
              "F_rows", "has_far", "has_entries", "n_exit_flat"):
        assert getattr(tp, f) == getattr(jtp, f) == getattr(rtp, f), f
    for k in ("in_slot", "out_slot", "m", "D"):
        assert np.array_equal(tp._coarse_meta[k], jtp._coarse_meta[k]), k
    if not isinstance(jtp.coarse, jtpm._CoarseGather):
        for f in ("n_pad", "n_in", "n_out", "has_far"):
            assert getattr(tp.coarse, f) == getattr(jtp.coarse, f) == getattr(rtp.coarse, f), f
    if isinstance(jtp.coarse, jbig.BigAccelPlan):
        assert tp.coarse.slot_mode and jtp.coarse.slot_mode
        assert tp.coarse.G1 == jtp.coarse.r_in.G1 == 1
        assert tp.coarse.n_in > tp.n_exit_flat  # the entry nodes' zero slots


def test_composed_indices_equal_the_replayed_jax_tables(plans):
    tp, rtp = plans["tp"], plans["rtp"]
    assert set(tp.idx) == set(rtp.idx) == {"rin", "rout", "near_end", "far_end",
                                          "ex_end", "ent_idx"}
    for k in tp.idx:
        assert tp.idx[k].dtype == rtp.idx[k].dtype == np.int32, k
        assert np.array_equal(tp.idx[k], rtp.idx[k]), k
    if isinstance(tp.coarse, tbig.RouterAccel):
        for k in ("src_in", "near_end", "src_out", "far_end"):
            assert np.array_equal(getattr(tp.coarse, k), getattr(rtp.coarse, k)), k
        # off-tree output slots (far_end -2) give 0 whatever their source
        on = tp.coarse.far_end != -2
        # against the JAX coarse level's lane and mask tables
        jc = plans["jtp"].coarse
        names = ("near_sel", "idx_near", "sel_next", "tree_mask")
        jnp_ = ({k: v.ravel() for k, v in jc._np.items()} if hasattr(jc, "_np")
                else {k: np.asarray(getattr(jc, k)).ravel() for k in names})
        assert np.array_equal(tp.coarse.near_end, ttp._near_end(
            jnp_["near_sel"], jnp_["idx_near"], jnp_["sel_next"]))
        assert np.array_equal(on, jnp_["tree_mask"][: on.size])
        # entry nodes and padding read past the exits: H1 gives them 0
        assert (tp.coarse.src_in >= tp.n_exit_flat).any()
    if isinstance(tp.coarse, ttp._CoarseRouterSmall):
        assert np.array_equal(tp.coarse.src_in < tp.coarse.n_pad, jnp_["in_sel"])


def test_coarse_kernel_indices(plans):
    """The router coarse level's H2 and H3 indices (slot mode), native and
    replayed: each tree slot's interval end where its span is below 128 or
    an output reads it, else -1; each output's preorder slot, -1 off the
    tree."""
    if not isinstance(plans["tp"].coarse, tbig.RouterAccel):
        pytest.skip("the gather coarse level has no router indices")
    for co in (plans["tp"].coarse, plans["rtp"].coarse):
        pre, size = co.dfs.preorder_np, co.dfs.size_np
        k = np.arange(pre.size)
        e = k + size[pre] - 1
        src_res = co._t["src_res"].numpy()
        assert np.array_equal(src_res, np.where(co.far_end != -2, co.src_out[: co.n_out], -1))
        read = np.zeros(co.n_pad, bool)
        read[src_res[src_res >= 0]] = True
        keep = (e - k < 128) | read[: pre.size]
        want = np.full(co.n_pad, -1)
        want[: pre.size][keep] = e[keep]
        assert np.array_equal(co._t["end"].numpy(), want)
        assert (keep & (e - k >= 128)).any() == co.has_far


def test_rin_rout_inverse(plans):
    tp = plans["tp"]
    rin, rout = tp.idx["rin"], tp.idx["rout"]
    on = rout >= 0
    assert np.array_equal(np.take_along_axis(rin, np.where(on, rout, 0), 1)[on],
                          np.broadcast_to(np.arange(rin.shape[1]), rin.shape)[on])


def test_exits_at_real_roots_bitwise(plans):
    jtp, tp = plans["jtp"], plans["tp"]
    H, W = tp.shape
    rng = np.random.RandomState(4)
    x = rng.randint(0, 9, H * W).astype(np.int32)
    cfg = jtp._acc_cfg(x.dtype)
    xg = jnp.asarray(x.reshape(H, W)).astype(cfg["acc"])
    xg = jnp.pad(xg, ((0, tp.pshape[0] - H), (0, tp.pshape[1] - W)))
    ex_j, _ = jax.jit(lambda xg, arrs: jtp._pass_a_fused(xg, arrs, cfg))(xg, jtp.arrays())
    ex_j = np.asarray(ex_j).reshape(tp.NT, -1)
    ex_t, c = kernels.tile_pass_a(torch.as_tensor(x), tp.idx_t["rin"],
                                  tp.idx_t["ex_end"], tp.shape)
    assert ex_t.dtype == c.dtype == torch.int32
    cnt_r = jtp._root_np[0]
    real = np.arange(tp.R_pad)[None, :] < cnt_r[:, None]
    assert np.array_equal(ex_t.numpy()[real], ex_j[real])


@pytest.mark.parametrize("kind", ["ones", "int32", "int64_wide", "int32_wrap", "uint8"])
def test_accumulate_int_bitwise(plans, kind):
    ids, jtp, tp, rtp = plans["ids"], plans["jtp"], plans["tp"], plans["rtp"]
    rng = np.random.RandomState(5)
    n = ids.size
    data = {"ones": np.ones(n, np.int32),
            "int32": rng.randint(-50, 1000, n).astype(np.int32),
            # |max| * n >= 2^31: the port accumulates in int64
            "int64_wide": rng.randint(0, 1 << 20, n).astype(np.int64),
            # sums past 2^31: int32 wraps, the exact sum's low 32 bits
            "int32_wrap": rng.randint(0, 1 << 28, n).astype(np.int32),
            "uint8": rng.randint(0, 256, n).astype(np.uint8)}[kind]
    reads = trace.host_reads["acc_dtype"]
    assert kernels.acc_dtype(torch.as_tensor(data)) == (
        torch.int64 if kind == "int64_wide" else torch.int32)
    kernels.reset_launches()
    got = tp.accumulate(torch.as_tensor(data))
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    # only 64-bit integer data reads its range to the host
    assert trace.host_reads["acc_dtype"] - reads == (4 if kind == "int64_wide" else 0)
    assert got.dtype == torch.as_tensor(data).dtype
    got = got.numpy()
    want_fused = _jax_up(jtp, data)
    dfs = tplan.build_plan(ids, device="cpu")
    # the int64 DFS plan, cast back to the data's dtype
    want_plan = tplan.accumulate_planned(dfs, torch.as_tensor(data)).numpy()
    assert np.array_equal(got, want_plan)
    if kind == "int32_wrap":
        wide = tplan.accumulate_planned(dfs, torch.as_tensor(data, dtype=torch.int64))
        assert int(wide.max()) >= 1 << 31
        assert np.array_equal(got, wide.to(torch.int32).numpy())
    assert np.array_equal(rtp.accumulate(torch.as_tensor(data)).numpy(), got)
    if kind == "int64_wide" and not isinstance(jtp.coarse, jtpm._CoarseGather):
        # the JAX router coarse levels sum in int32 whatever the input
        # (tile_plan.py:726, accel_big.py:539): past 2^31 only the DFS plan
        # is the reference
        return
    assert np.array_equal(got, want_fused)
    assert np.array_equal(got, _jax_unfused(jtp, data))


def test_accumulate_float64_close(plans):
    ids, jtp, tp = plans["ids"], plans["jtp"], plans["tp"]
    rng = np.random.RandomState(7)
    w = rng.rand(ids.size)
    got = tp.accumulate(torch.as_tensor(w))
    assert got.dtype == torch.float64
    got = got.numpy()
    want = np.asarray(jplan.accumulate_planned(jplan.build_plan(ids, fast=False),
                                               jnp.asarray(w)))
    total = w[ids >= 0].sum()
    tol = dict(rtol=1e-12, atol=2 * ids.size * _EPS * total)
    np.testing.assert_allclose(got, want, **tol)
    if isinstance(jtp.coarse, jtpm._CoarseGather):
        np.testing.assert_allclose(got, _jax_up(jtp, w), **tol)
    # missing cells pass their values through unchanged
    mv = ids < 0
    assert np.array_equal(got[mv], w[mv])
    # float32 data comes back float32, summed in float64
    got32 = tp.accumulate(torch.as_tensor(w.astype(np.float32)))
    assert got32.dtype == torch.float32


def test_plain_pass_c_matches_jax_fused_pass_c(plans):
    jtp, tp = plans["jtp"], plans["tp"]
    H, W = tp.shape
    x = np.random.RandomState(9).randint(0, 5, H * W).astype(np.int64)
    cfg = jtp._acc_cfg(x.dtype)
    arrs = jtp.arrays()
    xg = jnp.pad(jnp.asarray(x.reshape(H, W)), ((0, tp.pshape[0] - H), (0, tp.pshape[1] - W)))
    ex, cg = jtp._pass_a_fused(xg, arrs, cfg)
    entv = np.asarray(jtp.coarse.accumulate(ex.reshape(-1), arrs["coarse"]))
    E = jtp.E_rows * 128
    ent = np.zeros(tp.NT * E, np.int64)
    ent[: min(entv.size, ent.size)] = entv[: ent.size]
    want = np.asarray(jtp._pass_c_fused(xg, cg, jnp.asarray(ent.reshape(tp.NT, -1, 128)),
                                        arrs, cfg))[:H, :W].reshape(-1)
    xt = torch.as_tensor(x)
    _, c = kernels.tile_pass_a(xt, tp.idx_t["rin"], tp.idx_t["ex_end"], tp.shape)
    entv_t = torch.as_tensor(ent.reshape(tp.NT, E)[:, : tp.E_pad])
    got = kernels.tile_pass_c(xt, c, entv_t, tp.idx_t["ent_idx"], tp.idx_t["near_end"],
                              tp.idx_t["far_end"], tp.idx_t["rout"], tp.shape)
    assert np.array_equal(got.numpy(), want)


def test_raster_dispatches_to_the_tile_plan(monkeypatch):
    d8 = _demo_d8((300, 200), 11)
    latlon = (0.01, 0.0, 5.0, 0.0, -0.01, 52.0)
    t = pyflwdir_torch.from_array(d8, transform=latlon, latlon=True, device="cpu")
    j = pyflwdir_tpu.from_array(d8, transform=latlon, latlon=True)
    monkeypatch.setattr(type(t), "_TILE_PLAN_MIN", 0)
    monkeypatch.setattr(type(j), "_TILE_PLAN_MIN", 0)
    calls = []
    real = ttp.TilePlan.accumulate
    monkeypatch.setattr(ttp.TilePlan, "accumulate",
                        lambda self, data: calls.append(data.dtype) or real(self, data))
    upa = t.upstream_area()
    assert upa.dtype == np.int32 and np.array_equal(upa, j.upstream_area())
    assert upa.ravel()[t.idxs_pit].sum() == int(t.mask.sum())
    km2, km2_j = t.upstream_area("km2"), j.upstream_area("km2")
    total = km2_j.ravel()[t.idxs_pit].sum()
    np.testing.assert_allclose(km2, km2_j, rtol=1e-12, atol=2 * t.size * _EPS * total)
    data = np.random.RandomState(2).randint(0, 7, t.shape).astype(np.int64)
    assert np.array_equal(t.accuflux(data), j.accuflux(data))
    assert calls == [torch.int32, torch.float64, torch.int64]
    assert isinstance(t._cached["tile_plan"], ttp.TilePlan)


def test_coarse_beyond_the_small_router_raises(monkeypatch):
    """Beyond the single-chunk router the coarse level is a BigAccelPlan, as
    in the JAX build; beyond that one's capacity the build raises the JAX
    build's ValueError."""
    d8 = _demo_d8((300, 200), 3)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    monkeypatch.setattr(ttp, "_COARSE_ROUTER_MIN", 1)
    monkeypatch.setattr(ttp, "_COARSE_SMALL_MAX", 0)
    tp = ttp.build_tile_plan(ids, d8.shape, device="cpu")
    assert isinstance(tp.coarse, tbig.BigAccelPlan) and tp.coarse.slot_mode
    ones = torch.ones(ids.size, dtype=torch.int32)
    want = tplan.accumulate_planned(tplan.build_plan(ids, device="cpu"), ones)
    assert torch.equal(tp.accumulate(ones), want)
    monkeypatch.setattr(tbig, "_CHUNK", 8)  # capacity 128 * 8 slots
    with pytest.raises(ValueError, match="coarse graph exceeds router capacity"):
        ttp.build_tile_plan(ids, d8.shape, device="cpu")


@pytest.mark.parametrize("tile_rows", [256])
def test_jax_plans_of_other_tile_heights_do_not_load(tile_rows):
    """JAX plans of tiles taller than 128 rows load: the replay keeps the
    height, equals the port's own build of it and accumulates as the JAX
    plan does (every height is held in ``tests/test_torch_tile_tall.py``)."""
    d8 = _demo_d8((300, 200), 3)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    jtp = jtpm.build_tile_plan(ids, d8.shape, tile_rows=tile_rows)
    rtp = _replay(jtp)
    tp = ttp.build_tile_plan(ids, d8.shape, tile_rows=tile_rows, device="cpu")
    assert rtp.Y == tp.Y == jtp.Y == tile_rows and rtp.grid == tp.grid == jtp.grid
    for k in tp.idx:
        assert np.array_equal(rtp.idx[k], tp.idx[k]), k
    ones = np.ones(ids.size, np.int32)
    assert np.array_equal(rtp.accumulate(torch.as_tensor(ones)).numpy(), _jax_up(jtp, ones))
