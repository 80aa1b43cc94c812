"""Saved tile plans: a plan directory written by the JAX package's
``save_plans`` loads in the port (``ops/plan_io.py``) and gives
``upstream_area()`` and ``stream_distance()`` bitwise equal to the JAX
package's, for the three coarse levels, with and without the downward
tables; a plan the port saves loads with no phase 1, no sort phase and no
tile-plan build, and gives the built plan's results. On the CPU; grids of
260x140 (the gather coarse level) and 256x256 with the coarse thresholds
lowered in both packages (the single-chunk router and ``BigAccelPlan``)."""

import json

import numpy as np
import pytest
import torch

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import runtime
from pyflwdir_torch.ops import plan_io
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu.ops import tile_plan as jtpm
from tests.test_torch_tile_plan import _demo_d8, _Thresholds

# name: (grid, _COARSE_ROUTER_MIN, _COARSE_SMALL_MAX, coarse level)
_GRIDS = {
    "260x140": (lambda: _demo_d8((260, 140), 41), None, None, "_CoarseGather"),
    "256x256-router": (lambda: _demo_d8((256, 256), 8), 1, None, "_CoarseRouterSmall"),
    "256x256-big": (lambda: _demo_d8((256, 256), 8), 1, 0, "BigAccelPlan"),
}


def _rasters(d8, monkeypatch):
    """The JAX and the port's raster of ``d8``, both above their tile-plan
    threshold."""
    j = pyflwdir_tpu.from_array(d8, ftype="d8")
    t = pyflwdir_torch.from_array(d8, ftype="d8", device="cpu")
    monkeypatch.setattr(type(j), "_TILE_PLAN_MIN", 0)
    monkeypatch.setattr(type(t), "_TILE_PLAN_MIN", 0)
    return j, t


def _no_rebuild(monkeypatch):
    """Make every per-tile build step of the port raise."""
    def boom(*a, **k):
        raise AssertionError("rebuilt")

    monkeypatch.setattr(runtime, "tile_plan_phase1", boom)
    monkeypatch.setattr(runtime, "tile_down_phase", boom)
    monkeypatch.setattr(ttp.TilePlan, "__init__", boom)


@pytest.fixture(scope="module", params=list(_GRIDS))
def jax_saved(request, tmp_path_factory):
    """One JAX raster per grid, its results, and its plan saved with and
    without the downward tables."""
    make, router_min, small_max, coarse_kind = _GRIDS[request.param]
    d8 = make()
    j = pyflwdir_tpu.from_array(d8, ftype="d8")
    root = tmp_path_factory.mktemp(request.param)
    with pytest.MonkeyPatch.context() as mp, _Thresholds(router_min, small_max):
        mp.setattr(type(j), "_TILE_PLAN_MIN", 0)
        upa, dist = j.upstream_area(), j.stream_distance()
        assert type(j._cached["tile_plan"].coarse).__name__ == coarse_kind
        j.save_plans(root / "down", down=True)
        j._tile_plan().save(root / "up", down=False)
    return dict(d8=d8, upa=upa, dist=dist, root=root, coarse_kind=coarse_kind,
                thresholds=(router_min, small_max))


@pytest.mark.parametrize("down", [True, False])
def test_jax_saved_plan_loads_bitwise(jax_saved, down, monkeypatch):
    _, t = _rasters(jax_saved["d8"], monkeypatch)
    _no_rebuild(monkeypatch)
    tp = t.load_plans(jax_saved["root"] / ("down" if down else "up"))
    assert type(tp.coarse).__name__ == jax_saved["coarse_kind"]
    assert t._tile_plan() is tp
    upa = t.upstream_area()
    assert upa.dtype == jax_saved["upa"].dtype and np.array_equal(upa, jax_saved["upa"])
    if down:
        dist = t.stream_distance()
        assert dist.dtype == np.int32 and np.array_equal(dist, jax_saved["dist"])
    else:
        with pytest.raises(RuntimeError, match="downward"):
            t.stream_distance()


@pytest.mark.parametrize("mmap", [True, False])
def test_port_round_trip_without_rebuild(jax_saved, mmap, tmp_path, monkeypatch):
    d8 = jax_saved["d8"]
    _, t = _rasters(d8, monkeypatch)
    with _Thresholds(*jax_saved["thresholds"]):
        upa, dist = t.upstream_area(), t.stream_distance()
        km2 = t.upstream_area("km2")
    built = t._tile_plan()
    meta = t.save_plans(tmp_path / "plan")
    assert meta["kind"] == plan_io.KIND and meta["down"]
    with open(tmp_path / "plan" / "plan.json") as f:
        assert json.load(f) == meta

    _, t2 = _rasters(d8, monkeypatch)
    _no_rebuild(monkeypatch)
    tp = t2.load_plans(tmp_path / "plan", mmap=mmap)
    assert type(tp.coarse).__name__ == jax_saved["coarse_kind"]
    for f in ("shape", "NT", "far_mode", "b", "R_pad", "E_pad", "F_rows", "has_far",
              "has_entries", "n_exit_flat"):
        assert getattr(tp, f) == getattr(built, f), f
    assert isinstance(tp.idx["rin"], np.memmap) == mmap
    # a banded sweep reads the band slices and uploads no whole table
    ones = tp.accumulate_banded(None, band_tile_rows=1)
    assert tp._idx_t is None and np.array_equal(ones.ravel()[t2.mask.ravel()],
                                                upa.ravel()[t2.mask.ravel()])
    assert np.array_equal(t2.upstream_area(), upa)
    assert np.array_equal(t2.upstream_area("km2"), km2)
    assert np.array_equal(t2.stream_distance(), dist)
    for k in built.down_idx:
        assert np.array_equal(tp.down_idx[k], built.down_idx[k]), k
    for k in built.coarse.down:
        assert np.array_equal(tp.coarse.down[k], built.coarse.down[k]), k
    # a loaded plan saves again, and a plan saved without its downward
    # tables loads without them
    tp.save(tmp_path / "again", down=False)
    tp3 = ttp.TilePlan.load(tmp_path / "again", device="cpu")
    x = torch.ones(d8.size, dtype=torch.int32)
    assert torch.equal(tp3.accumulate(x), built.accumulate(x))
    with pytest.raises(RuntimeError, match="downward"):
        tp3.accumulate_down(x)


def test_load_plans_of_another_shape_raises(jax_saved, tmp_path, monkeypatch):
    _, t = _rasters(_demo_d8((132, 140), 42), monkeypatch)
    with pytest.raises(ValueError, match="shape"):
        t.load_plans(jax_saved["root"] / "up")


def test_not_a_plan_directory_raises(tmp_path):
    (tmp_path / "plan.json").write_text(json.dumps({"format": 1, "kind": "something"}))
    with pytest.raises(ValueError, match="not a tile-plan directory"):
        plan_io.load_tile_plan(tmp_path, device="cpu")


def test_jax_plan_of_256_rows_raises(tmp_path):
    """A JAX plan of 256-row tiles loads (it raised before the port took
    tall tiles): the height kept, the JAX plan's accumulation bitwise;
    saved without its downward tables, ``accumulate_down`` raises."""
    import jax
    import jax.numpy as jnp

    from pyflwdir_torch.codecs import d8 as td8

    d8 = _demo_d8((300, 200), 3)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    jtp = jtpm.build_tile_plan(ids, d8.shape, tile_rows=256)
    jtp.save(tmp_path / "p", down=False)
    tp = ttp.TilePlan.load(tmp_path / "p", device="cpu")
    assert (tp.Y, tp.G, tp.grid) == (256, 2, jtp.grid)
    ones = np.ones(ids.size, np.int32)
    want = np.asarray(jax.jit(jtp.accumulate)(jnp.asarray(ones), jtp.arrays()))
    assert np.array_equal(tp.accumulate(torch.as_tensor(ones)).numpy(), want)
    with pytest.raises(RuntimeError, match="downward"):
        tp.accumulate_down(torch.as_tensor(ones))
