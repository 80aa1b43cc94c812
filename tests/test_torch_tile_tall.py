"""Tile plans of 256, 384 and 512 rows (``tile_rows``; the kernels' tiles of
128 G rows, G 2 to 4) against the JAX package's, on the CPU (the kernels'
plain versions).

Grids, each at the three heights (a module each: 256 rows here, 384 and
512 in ``test_torch_tile_tall_384.py`` and ``_512.py``): a filled demo D8
of 600 x 300 with missing cells and entry cells (6 to 9 tiles, padding;
the gather coarse level); a serpentine chain of 2 Y x 128 (the packed far mode); the demo
grid with ``_COARSE_ROUTER_MIN`` lowered in both packages (the single-chunk
router coarse level). Held:

* the build decisions, and the port's composed indices equal to a replay of
  the JAX plan's stage tables (with the group stage ``*_ig`` of a tall
  tile), up and down; ``rin`` and ``rout`` inverse on the tree slots;
* ``accumulate`` int32 and int64 bitwise the JAX fused path, the DFS plan
  and the replayed plan; ``accumulate_down`` bitwise the JAX package's and
  the native downward sweep; float64 within rtol 1e-12 plus 2 L eps total
  of the native sweeps, L the additions on the longest chain summed in
  another order: a tile's T = 128 Y slots, its entry scan (E_pad) and the
  coarse level's slots (twice downward), and twice the same bits;
* ``accumulate_banded`` with ``band_tile_rows`` 1 and None bitwise the JAX
  banded sweep (the demo grid);
* a JAX tall plan saved with and without its downward tables loads
  (``plan_io``) and gives the JAX results; the port's format keeps
  ``tile_rows``; ``FlwdirRaster.load_plans`` of a tall JAX plan gives
  ``upstream_area()``, ``stream_distance()``, ``basins()`` and
  ``stream_order()`` equal to the JAX raster's after its own
  ``load_plans`` (512 rows) and to the 128-row plan's (256 and 384 rows);
* heights other than 128, 256, 384 and 512 raise the JAX build's
  ValueError.

The JAX sweeps run under ``jax.jit`` with the plan's arrays as arguments
(called eagerly, each operation compiles apart), the banded one pass by
pass; each plan is built once a module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import kernels, runtime
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import plan as tplan
from pyflwdir_torch.ops import plan_io
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu.ops import tile_plan as jtpm
from tests.test_torch_tile_plan import _demo_d8, _jit_banded, _serpentine, _Thresholds

_EPS = np.finfo(np.float64).eps
HEIGHTS = (256, 384, 512)

# kind: (grid of the tile height Y, _COARSE_ROUTER_MIN, coarse level, far mode)
_KINDS = {
    "demo": (lambda Y: _demo_d8((600, 300), 3), None, "_CoarseGather", "router"),
    "serpentine": (lambda Y: _serpentine(2 * Y, 128), None, "_CoarseGather", "packed"),
    "router": (lambda Y: _demo_d8((600, 300), 3), 1, "_CoarseRouterSmall", "router"),
}


def _cfg(jtp):
    return dict(shape=jtp.shape, tile_rows=jtp.Y, far_mode=jtp.far_mode, b=jtp.b,
                R_pad=jtp.R_pad, E_pad=jtp.E_pad, F_rows=jtp.F_rows, has_far=jtp.has_far,
                has_entries=jtp.has_entries)


def _replay(jtp):
    """The port's plan from the JAX plan's host arrays, down tables included."""
    jtp._ensure_down()
    dfs = jtp._coarse_dfs
    router = not isinstance(jtp.coarse, jtpm._CoarseGather)
    down = dict(tabs=jtp._down["tabs"], cd=jtp._down["cd"],
                routers=jtp.coarse.down_router_tables() if router else None)
    return ttp.TilePlan.from_stage_tables(
        jtp._tabs_np, _cfg(jtp), jtp._coarse_meta, (dfs.preorder_np, dfs.pos_np, dfs.size_np),
        routers=jtp.coarse.router_tables() if router else None, down=down, device="cpu")


def _plans(request):
    kind, Y = request.param
    make, router_min, coarse_kind, far_mode = _KINDS[kind]
    d8 = make(Y)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    with _Thresholds(router_min, None):
        jtp = jtpm.build_tile_plan(ids, d8.shape, tile_rows=Y)
        tp = ttp.build_tile_plan(ids, d8.shape, tile_rows=Y, device="cpu")
    assert type(jtp.coarse).__name__ == type(tp.coarse).__name__ == coarse_kind
    assert jtp.far_mode == tp.far_mode == far_mode
    seq = runtime.dfs_preorder(ids)[0]  # downstream cells before upstream ones
    return dict(kind=kind, Y=Y, d8=d8, ids=ids, jtp=_jit_banded(jtp), tp=tp, rtp=_replay(jtp),
                seq=seq)


def plans_fixture(heights):
    """The module fixture ``plans``: each kind's grid at each of ``heights``,
    built in both packages once a module. Each tile height's plan tests run
    in a module of their own (here 256 rows; ``test_torch_tile_tall_384.py``
    and ``_512.py``), so that parallel workers share them out."""
    return pytest.fixture(scope="module", name="plans",
                          params=[(k, Y) for k in _KINDS for Y in heights],
                          ids=[f"{k}-{Y}" for k in _KINDS for Y in heights])(_plans)


plans = plans_fixture((256,))


def _jax_up(jtp, x):
    return np.asarray(jax.jit(jtp.accumulate)(jnp.asarray(x), jtp.arrays()))


def _jax_down(jtp, x):
    return np.asarray(jax.jit(jtp.accumulate_down)(jnp.asarray(x), jtp.down_arrays()))


def _int_data(kind, n):
    rng = np.random.RandomState(5)
    return {"int32": rng.randint(-50, 1000, n).astype(np.int32),
            # |max| * n >= 2^31: the port accumulates in int64
            "int64_wide": rng.randint(0, 1 << 20, n).astype(np.int64)}[kind]


def _length(tp, down=False):
    """The float64 rule's L: a tile's T = 128 Y slots, the tile's entry scan
    and the coarse level's slots (each twice downward: a prefix and a
    suffix sum)."""
    n_coarse = tp._coarse_meta["m"] + tp._coarse_meta["D"]
    T = tp.Y * 128
    return 2 * (T + n_coarse) if down else T + tp.E_pad + n_coarse


def test_build_decisions_equal(plans):
    jtp, tp, rtp, Y = plans["jtp"], plans["tp"], plans["rtp"], plans["Y"]
    assert tp.Y == jtp.Y == rtp.Y == Y and tp.G == jtp.G == rtp.G == Y // 128
    for f in ("shape", "pshape", "grid", "NT", "far_mode", "b", "R_pad", "E_pad", "F_rows",
              "has_far", "has_entries", "n_exit_flat"):
        assert getattr(tp, f) == getattr(jtp, f) == getattr(rtp, f), f
    for k in ("in_slot", "out_slot", "m", "D"):
        assert np.array_equal(tp._coarse_meta[k], jtp._coarse_meta[k]), k
    if not isinstance(jtp.coarse, jtpm._CoarseGather):
        for f in ("n_pad", "n_in", "n_out", "has_far"):
            assert getattr(tp.coarse, f) == getattr(jtp.coarse, f) == getattr(rtp.coarse, f), f
    H, W = plans["d8"].shape
    assert tp.pshape == (-(-H // Y) * Y, -(-W // 128) * 128)


def test_composed_indices_equal_the_replayed_jax_tables(plans):
    tp, rtp = plans["tp"], plans["rtp"]
    T = tp.Y * 128
    assert plans["jtp"]._tabs_np["rin_ig"].shape == (tp.NT, 128 * 128, tp.G)
    for k in tp.idx:
        assert tp.idx[k].dtype == rtp.idx[k].dtype == np.int32, k
        assert np.array_equal(tp.idx[k], rtp.idx[k]), k
    rin, rout = tp.idx["rin"], tp.idx["rout"]
    assert rin.shape == rout.shape == (tp.NT, T)
    assert int(rin.max()) < T and int(rout.max()) < T
    tp._ensure_down()
    rtp._ensure_down()
    n_tree = tp.down_idx["n_tree"]
    for t in range(tp.NT):
        s = np.arange(n_tree[t])
        assert np.array_equal(rout[t, rin[t, s]], s)  # inverse on the tree slots
        on = rout[t] >= 0
        assert np.array_equal(rin[t, rout[t, on]], np.nonzero(on)[0])
        assert int(on.sum()) == n_tree[t]
    for k in tp.down_idx:
        assert np.array_equal(tp.down_idx[k], rtp.down_idx[k]), k
    for k in tp.coarse.down:
        assert np.array_equal(tp.coarse.down[k], rtp.coarse.down[k]), k


@pytest.mark.parametrize("kind", ["int32", "int64_wide"])
def test_accumulate_int_bitwise(plans, kind):
    ids, jtp, tp, rtp = plans["ids"], plans["jtp"], plans["tp"], plans["rtp"]
    data = _int_data(kind, ids.size)
    kernels.reset_launches()
    got = tp.accumulate(torch.as_tensor(data))
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert got.dtype == torch.as_tensor(data).dtype
    got = got.numpy()
    if kind == "int32" or isinstance(jtp.coarse, jtpm._CoarseGather):
        # the JAX router coarse levels sum in int32 whatever the input
        # (tile_plan.py:726): past 2^31 only the DFS plan is the reference
        assert np.array_equal(got, _jax_up(jtp, data))
    dfs = tplan.build_plan(ids, device="cpu")
    assert np.array_equal(got, tplan.accumulate_planned(dfs, torch.as_tensor(data)).numpy())
    assert np.array_equal(rtp.accumulate(torch.as_tensor(data)).numpy(), got)


def test_accumulate_down_int_bitwise(plans):
    ids, jtp, tp, rtp = plans["ids"], plans["jtp"], plans["tp"], plans["rtp"]
    data = _int_data("int32", ids.size)
    got = tp.accumulate_down(torch.as_tensor(data)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, _jax_down(jtp, data))
    want = runtime.downward_sweep(ids, plans["seq"], data.astype(np.float64))
    assert np.array_equal(got, want.astype(np.int32))
    assert np.array_equal(rtp.accumulate_down(torch.as_tensor(data)).numpy(), got)
    assert np.array_equal(got[ids < 0], data[ids < 0])  # missing cells pass through


def test_accumulate_float64_close(plans):
    ids, tp, seq = plans["ids"], plans["tp"], plans["seq"]
    w = np.random.RandomState(7).rand(ids.size)
    total = w[ids >= 0].sum()
    for down, sweep in ((False, runtime.accuflux_sweep), (True, runtime.downward_sweep)):
        call = tp.accumulate_down if down else tp.accumulate
        got = call(torch.as_tensor(w))
        assert got.dtype == torch.float64
        assert torch.equal(got, call(torch.as_tensor(w)))  # the same bits twice
        np.testing.assert_allclose(got.numpy(), sweep(ids, seq, w), rtol=1e-12,
                                   atol=2 * _length(tp, down) * _EPS * total)


@pytest.mark.parametrize("band_tile_rows", [1, None])
def test_banded_bitwise(plans, band_tile_rows):
    """Bitwise the port's ``accumulate`` and, on the demo grid, the JAX
    banded sweep; the bands reach ``out_cb`` in order, Y rows a tile row."""
    jtp, tp, shape = plans["jtp"], plans["tp"], plans["d8"].shape
    data = np.random.RandomState(61).randint(-5, 9, shape).astype(np.int32)
    got = tp.accumulate_banded(data, band_tile_rows=band_tile_rows)
    assert got.dtype == np.int32 and got.shape == shape
    assert np.array_equal(got.ravel(), tp.accumulate(torch.as_tensor(data.ravel())).numpy())
    if plans["kind"] == "demo":
        assert np.array_equal(got, np.asarray(jtp.accumulate_banded(data, band_tile_rows)))
    parts = []
    tp.accumulate_banded(data, band_tile_rows, out_cb=lambda b, r0, a: parts.append((b, r0)))
    btr = band_tile_rows or tp.grid[0]
    assert parts == [(b, b * btr * tp.Y) for b in range(-(-tp.grid[0] // btr))]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The demo grid's JAX plan at each height, saved with and without its
    downward tables, and the JAX results of the plan."""
    d8 = _demo_d8((600, 300), 3)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    out = {"d8": d8, "ids": ids}
    ones = np.ones(ids.size, np.int32)
    for Y in HEIGHTS:
        root = tmp_path_factory.mktemp(f"tall{Y}")
        jtp = jtpm.build_tile_plan(ids, d8.shape, tile_rows=Y)
        jtp.save(root / "up", down=False)
        jtp.save(root / "down", down=True)
        out[Y] = dict(root=root, up=_jax_up(jtp, ones), down=_jax_down(jtp, ones))
    return out


@pytest.mark.parametrize("down", [True, False])
@pytest.mark.parametrize("Y", HEIGHTS)
def test_jax_tall_plan_loads(saved, Y, down):
    tp = ttp.TilePlan.load(saved[Y]["root"] / ("down" if down else "up"), device="cpu")
    assert tp.Y == Y and tp.G == Y // 128
    ones = torch.ones(saved["ids"].size, dtype=torch.int32)
    assert np.array_equal(tp.accumulate(ones).numpy(), saved[Y]["up"])
    if down:
        assert np.array_equal(tp.accumulate_down(ones).numpy(), saved[Y]["down"])
    else:
        with pytest.raises(RuntimeError, match="downward"):
            tp.accumulate_down(ones)


@pytest.mark.parametrize("Y", HEIGHTS)
def test_port_format_keeps_tile_rows(saved, Y, tmp_path):
    tp = plan_io.load_tile_plan(saved[Y]["root"] / "down", device="cpu")
    meta = tp.save(tmp_path / "p")
    assert meta["tile_rows"] == Y and meta["kind"] == plan_io.KIND
    tp2 = ttp.TilePlan.load(tmp_path / "p", mmap=False, device="cpu")
    assert (tp2.Y, tp2.G, tp2.grid, tp2.NT) == (Y, Y // 128, tp.grid, tp.NT)
    for k in tp.idx:
        assert np.array_equal(tp2.idx[k], tp.idx[k]), k
    ones = torch.ones(saved["ids"].size, dtype=torch.int32)
    assert np.array_equal(tp2.accumulate(ones).numpy(), saved[Y]["up"])
    assert np.array_equal(tp2.accumulate_down(ones).numpy(), saved[Y]["down"])
    assert np.array_equal(tp2.accumulate_banded(None, 1).ravel(), saved[Y]["up"])


_METHODS = ("upstream_area", "stream_distance", "basins", "stream_order")


@pytest.fixture(scope="module")
def raster_refs(saved):
    """The JAX raster's results after its own ``load_plans`` of the 512-row
    plan, and the port's 128-row plan's, both above the tile-plan
    threshold."""
    d8 = saved["d8"]
    with pytest.MonkeyPatch.context() as mp:
        j = pyflwdir_tpu.from_array(d8, ftype="d8")
        t = pyflwdir_torch.from_array(d8, ftype="d8", device="cpu")
        mp.setattr(type(j), "_TILE_PLAN_MIN", 0)
        mp.setattr(type(t), "_TILE_PLAN_MIN", 0)
        j.load_plans(saved[512]["root"] / "down")
        assert j._cached["tile_plan"].Y == 512
        jax_res = {m: getattr(j, m)() for m in _METHODS}
        port128 = {m: getattr(t, m)() for m in _METHODS}
        assert t._tile_plan().Y == 128
    return {"jax": jax_res, "port128": port128}


@pytest.mark.parametrize("Y", HEIGHTS)
def test_load_plans_of_a_tall_jax_plan(saved, raster_refs, Y, monkeypatch):
    """``FlwdirRaster.load_plans`` of a tall JAX plan: the raster methods
    through it equal the JAX raster's after its own ``load_plans`` of the
    512-row plan, and the port's 128-row plan's."""
    t = pyflwdir_torch.from_array(saved["d8"], ftype="d8", device="cpu")
    monkeypatch.setattr(type(t), "_TILE_PLAN_MIN", 0)
    tp = t.load_plans(saved[Y]["root"] / "down")
    assert tp.Y == Y and t._tile_plan() is tp
    for m in _METHODS:
        got = getattr(t, m)()
        for ref in ("jax", "port128"):
            want = raster_refs[ref][m]
            assert got.dtype == want.dtype and np.array_equal(got, want), (m, ref)
    assert t._tile_plan() is tp  # the cut-graph methods build their own plans


@pytest.mark.parametrize("tile_rows", [0, 64, 200, 640, 1024])
def test_other_heights_raise_the_jax_value_error(tile_rows):
    ids = td8.from_array(_demo_d8((300, 200), 3), dtype=np.int64)[0]
    with pytest.raises(ValueError, match="multiple of 128"):
        ttp.build_tile_plan(ids, (300, 200), tile_rows=tile_rows, device="cpu")
    if tile_rows:
        with pytest.raises(ValueError, match="multiple of 128"):
            jtpm.build_tile_plan(ids, (300, 200), tile_rows=tile_rows)
