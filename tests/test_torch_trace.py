"""The port's spans and counters (``pyflwdir_torch.trace``) on the CPU.

Off by default: a span is then the one shared null context and nothing is
recorded. On: spans nest with their parents, the plan build keeps its
``build_seconds`` and ``down_build_seconds`` keys, and under
``torch.profiler`` a tile-plan and a 1-D router sweep show ``pf:up`` with its
stage spans inside the caller's range. ``host_reads`` counts the int64
call's two range reads and none of an int32 or a float64 call; ``casts``
the copies of a call's dtype conversions and the float32 downward calls
whose conversions T3 and T4 make. Results are the same bits with tracing
on and off."""

import functools

import numpy as np
import pytest
import torch

from pyflwdir_torch import trace
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_torch.ops.accel_big import build_big_accel_plan
from pyflwdir_torch.parallel import Mesh


def _scheidegger(shape, seed):
    """A D8 raster whose cells drain east, south-east or south; the last row
    and column are pits."""
    d8 = np.random.default_rng(seed).choice(np.array([1, 2, 4], np.uint8), size=shape)
    d8[-1, :] = 0
    d8[:, -1] = 0
    return d8


@pytest.fixture(scope="module")
def graph():
    d8 = _scheidegger((300, 260), 7)
    return td8.from_array(d8, dtype=np.int64)[0], d8.shape


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def _tile_plan(graph, monkeypatch):
    """A tile plan whose coarse level is the single-chunk router (H1-H3)."""
    monkeypatch.setattr(ttp, "_COARSE_ROUTER_MIN", 1)
    plan = ttp.build_tile_plan(*graph, device="cpu")
    assert type(plan.coarse).__name__ == "_CoarseRouterSmall"
    return plan


def _fields(n):
    g = torch.Generator().manual_seed(3)
    return (torch.ones(n, dtype=torch.int32),
            torch.randint(0, 5, (n,), dtype=torch.int32, generator=g),
            torch.rand(n, dtype=torch.float64, generator=g),
            torch.rand(n, dtype=torch.float32, generator=g))


def test_off_is_one_shared_null_context():
    trace.reset()
    a, b = trace.span("up"), trace.span("T1")
    assert a is b
    with a:
        with b:
            pass
    with trace.timed("plan.phase1") as s:
        pass
    assert s.seconds is not None and s.seconds >= 0
    assert trace.records() == []


def test_spans_nest_with_their_parents(tracing):
    with trace.span("up"):
        with trace.span("T1"):
            pass
        with trace.timed("coarse"):
            with trace.span("H1"):
                pass
    with trace.span("down"):
        pass
    got = [(name, parent) for name, parent, _, _ in trace.records()]
    assert got == [("T1", "up"), ("H1", "coarse"), ("coarse", "up"), ("up", None),
                   ("down", None)]
    assert all(a <= b for _, _, a, b in trace.records())
    trace.reset()
    assert trace.records() == []


def test_plan_build_keeps_its_keys(graph, monkeypatch, tracing):
    plan = _tile_plan(graph, monkeypatch)
    assert list(plan.build_seconds) == ["phase 1", "far tables", "exit tables",
                                        "coarse graph", "coarse plan"]
    assert plan.upload_seconds is None
    plan.arrays()
    plan.down_arrays()
    assert plan.upload_seconds > 0
    assert list(plan.down_build_seconds) == ["sort phase", "compose", "coarse down"]
    assert all(v >= 0 for v in [*plan.build_seconds.values(),
                                *plan.down_build_seconds.values()])
    parents = {(n, p) for n, p, _, _ in trace.records()}
    for pair in [("native.tile_plan_phase1", "plan.phase1"),
                 ("native.tile_pad_bijection", "plan.exit_tables"),
                 ("plan.dfs", "plan.coarse_plan"), ("native.dfs_preorder", "plan.dfs"),
                 ("plan.upload", "plan.coarse_plan"), ("plan.upload", None),
                 ("native.tile_down_phase", "plan.down.sort"),
                 ("plan.down.compose", None), ("plan.down.upload", "plan.down.coarse"),
                 ("plan.down.upload", None)]:
        assert pair in parents
    secs = {n: (b - a) / 1e9 for n, _, a, b in trace.records()}
    assert secs["plan.phase1"] == plan.build_seconds["phase 1"]


def test_the_same_keys_with_tracing_off(graph, monkeypatch):
    plan = _tile_plan(graph, monkeypatch)
    plan.down_arrays()
    assert list(plan.build_seconds) == ["phase 1", "far tables", "exit tables",
                                        "coarse graph", "coarse plan"]
    assert list(plan.down_build_seconds) == ["sort phase", "compose", "coarse down"]
    assert plan.upload_seconds > 0
    assert trace.records() == []


def _profiled(call, x, kind):
    """The profiler's events of ``call(x)`` inside the range
    ``bench:call:<kind>``: ``{name: [(start, end)]}`` of the ``bench:`` and
    ``pf:`` ranges."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(f"bench:call:{kind}"):
            call(x)
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("bench:", "pf:")):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(spans, inner, outer):
    (a, b), = spans[outer]
    return spans[inner] and all(a <= s and e <= b for s, e in spans[inner])


@pytest.mark.parametrize("engine", ["tile", "router"])
def test_stage_spans_inside_the_call_under_the_profiler(graph, monkeypatch, tracing, engine):
    x = torch.ones(graph[0].size, dtype=torch.int32)
    if engine == "tile":
        call, stages = _tile_plan(graph, monkeypatch).accumulate, ("T1", "coarse", "T2")
    else:
        call, stages = build_big_accel_plan(graph[0], device="cpu").accumulate, ("H1", "H2", "H3")
    call(x)
    spans = _profiled(call, x, "up.int32")
    assert _inside(spans, "pf:up", "bench:call:up.int32")
    for name in ("dtype", "cast", *stages):
        assert _inside(spans, f"pf:{name}", "pf:up"), name
    starts = [spans[f"pf:{n}"][0][0] for n in stages]
    assert starts == sorted(starts)
    if engine == "tile":  # the coarse level's router kernels inside it
        for name in ("H1", "H2", "H3"):
            assert _inside(spans, f"pf:{name}", "pf:coarse")


def test_down_stage_spans(graph, monkeypatch, tracing):
    """A float32 call has no dtype or cast span (T3 and T4 read and write
    float32); an int32 call has both."""
    plan = _tile_plan(graph, monkeypatch)
    x = torch.ones(graph[0].size, dtype=torch.float32)
    plan.accumulate_down(x)
    trace.reset()
    plan.accumulate_down(x)
    got = [(n, p) for n, p, _, _ in trace.records()]
    assert got == [("T3", "down"), ("coarse", "down"), ("T4", "down"), ("down", None)]
    trace.reset()
    plan.accumulate_down(x.to(torch.int32))
    got = [(n, p) for n, p, _, _ in trace.records()]
    assert got == [("dtype", "down"), ("cast", "down"), ("T3", "down"), ("coarse", "down"),
                   ("T4", "down"), ("cast", "down"), ("down", None)]


@pytest.mark.parametrize("engine", ["tile", "router", "sharded", "banded"])
def test_casts_by_site(graph, monkeypatch, engine):
    """``casts``: a float32 downward call on tiles counts one ``down.fused``
    and no copy; int32 and float64 calls count nothing; a float32 upward
    call (on tiles or a router plan) and an int16 downward one still copy
    in and out. The sharded sweeps (one rank) copy float32 data downward
    too, as T4's lite mode reads no float32; a banded call (one tile row a
    band) copies each band in, in each of its two passes, and each band's
    result back."""
    plan = _tile_plan(graph, monkeypatch)
    ones, _, floats, floats32 = _fields(graph[0].size)
    down, down32, up32 = plan.accumulate_down, {"down.fused": 1}, {"up.copy": 2}
    if engine == "tile":
        up = plan.accumulate
    elif engine == "router":
        up = build_big_accel_plan(graph[0], device="cpu").accumulate
    elif engine == "sharded":
        mesh = Mesh(None, 0, 1, (1, 1), "cpu")
        up = functools.partial(plan.accumulate_sharded, mesh=mesh)
        down = functools.partial(plan.accumulate_down_sharded, mesh=mesh)
        down32 = {"down.copy": 2}
    else:
        def up(x):
            return plan.accumulate_banded(x.reshape(graph[1]).numpy(), band_tile_rows=1)

        up32 = {"up.copy": 3 * plan.grid[0]}

    def delta(call, x):
        before = trace.counters()["casts"]
        call(x)
        after = trace.counters()["casts"]
        return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    assert delta(down, floats32) == down32
    for x in (ones, floats):
        assert delta(down, x) == {}
        assert delta(up, x) == {}
    assert delta(up, floats32) == up32
    assert delta(down, ones.to(torch.int16)) == {"down.copy": 2}


@pytest.mark.parametrize("engine", ["tile", "router"])
@pytest.mark.parametrize("dtype", ["int32", "int16", "uint8", "int64"])
def test_host_reads_per_call(graph, monkeypatch, engine, dtype):
    """An int32, int16 or uint8 call reads nothing to the host (its dtype
    alone sets int32 sums), an int64 call its range (two reads), a float64
    call nothing."""
    if engine == "tile":
        call = _tile_plan(graph, monkeypatch).accumulate
    else:
        call = build_big_accel_plan(graph[0], device="cpu").accumulate
    ones, _, floats, _ = _fields(graph[0].size)
    before = trace.counters()["host_reads"].get("acc_dtype", 0)
    call(ones.to(getattr(torch, dtype)))
    mid = trace.counters()["host_reads"].get("acc_dtype", 0)
    call(floats)
    after = trace.counters()["host_reads"].get("acc_dtype", 0)
    assert (mid - before, after - mid) == ((2, 0) if dtype == "int64" else (0, 0))
    assert "launches" in trace.counters()


def test_the_plan_upload_counts_its_range_reads(graph, monkeypatch):
    plan = _tile_plan(graph, monkeypatch)
    before = trace.counters()["host_reads"].get("cast_checked", 0)
    plan.arrays()
    # two a table: rin, rout, near_end, far_end, ex_end, ent_idx (n_tree is not cast)
    assert trace.counters()["host_reads"]["cast_checked"] - before == 2 * len(plan.idx)


def test_results_bitwise_with_tracing_on_and_off(graph, monkeypatch):
    tp = _tile_plan(graph, monkeypatch)
    big = build_big_accel_plan(graph[0], device="cpu")
    fields = _fields(graph[0].size)
    calls = [tp.accumulate, tp.accumulate_down, big.accumulate]

    def run():
        return [call(x) for call in calls for x in fields]

    off = run()
    trace.enable()
    try:
        on = run()
    finally:
        trace.disable()
        trace.reset()
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("cell", ["merit3s-tile.up", "hydrorivers.up", "merit3s-tile.down"])
def test_a_traced_cell_reads_the_program_spans(monkeypatch, cell):
    """``tools/trace_cell.py`` on a benchmark cell at a small size on the
    CPU: the program's numbers come out, the calls read nothing to the host
    (the cells' integer data is int32), and the idle time (all of the
    window: no device) splits into dispatch, launch and outside with nothing
    left over."""
    import time

    from pyflwdir_torch.raster import FlwdirRaster
    from tools import trace_cell

    from pyflwdir_torch.ops import accel

    monkeypatch.setattr(ttp, "_COARSE_ROUTER_MIN", 1)
    monkeypatch.setattr(FlwdirRaster, "_TILE_PLAN_MIN", 1)
    # the network's big router plan, as 8.5 M reaches take it
    monkeypatch.setattr(accel, "build_accel_plan", lambda ids, dfs=None, device=None:
                        build_big_accel_plan(ids, dfs, device=device))
    small = {"shape": [200, 300]} if cell.startswith("merit") else {"raster_shape": [150, 150]}
    res = trace_cell.trace_cell(cell, 2**31 + 11, 0.2, True, torch.device("cpu"),
                                time.perf_counter(), overrides=small)
    p = res["program"]
    assert res["correct"] and p["host_reads_per_call"] == 0.0
    # int32 and float64 fields convert nothing; float32 ones (every other
    # downward call) in T3 and T4
    assert p["casts_per_call"] == ({"down.fused": 0.5} if cell.endswith("down") else {})
    assert p["plan_native_s"] > 0 and p["plan_upload_s"] > 0
    outside = 100 * p["idle_outside_s"] / res["device"]["window_s"]
    assert p["idle_pct.dispatch"] + p["idle_pct.launch"] + outside == pytest.approx(100)
    assert not trace._on and trace.records() == []
