"""A whole run of each cell on the CPU at a small size, past the run's look
for a card, with the timed path broken underneath: ``correct`` has to come
out false for each fault a cell can have, and true without one. (The cells
take one chip, so no exchange between chips can be left out.)"""

import math
import time

import pytest
import torch

from benchmark import cells, manifest

BENCH = manifest.load()
CPU = torch.device("cpu")
SWEEP_CELLS = [w["name"] for w in BENCH["workloads"]
               if manifest.traffic(w["traffic"])["op"] in ("up", "down")]


def _run(cell, overrides, wrap=None, bench=BENCH):
    cfg = manifest.workload(bench, cell)["config"]
    res, checks = cells.run_cell(bench, cell, 2**31 + 17, 0.2, False, CPU, time.perf_counter(),
                                 wrap=wrap, overrides=overrides.get(cfg, overrides))
    return res


def _unchanged(call, x, j, prev):
    """The sweep returns its input: its state unchanged."""
    return x.clone()


def _half(call, x, j, prev):
    """The second half of the step's sweeps left out: their results are
    handed back unwritten."""
    return call(x) if j < 8 else torch.zeros_like(x)


def _altered(call, x, j, prev):
    """One answer altered where it is produced."""
    out = call(x)
    if j == 5:
        out = out.clone()
        out[out.numel() // 3] += 1
    return out


@pytest.mark.parametrize("cell", SWEEP_CELLS)
def test_sound_run_is_correct(cell, small_tile_path):
    res = _run(cell, small_tile_path)
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", SWEEP_CELLS)
def test_fault_is_not_correct(cell, fault, small_tile_path):
    res = _run(cell, small_tile_path, wrap=fault)
    assert res["correct"] is False, (fault.__name__, res["checks"])


def test_sweeps_left_out_of_a_step_count_as_wrong(small_tile_path, monkeypatch):
    step = cells.Sweeps.step
    monkeypatch.setattr(cells.Sweeps, "step", lambda self: step(self)[:8])
    res = _run(SWEEP_CELLS[0], small_tile_path)
    assert res["correct"] is False


# from_dem: the cell waits for the program's flat routing to be mended (see
# PERF.md); its driver and certificate run here on a plain tilt, whose D8 has
# no flat to route. The cell is added by entries alone: its workload, its name
# in the list of the rate (a window holds 2-3 calls, so its 95th percentile
# is the slowest call, no tail: the cell leaves step_p95_ms out), and the
# entries of its per-layer readers
DEM = "merit3s-tile.dem"
DEM_E2E = ("sweep_cells_per_s",)


def _listing_dem(m):
    return {**m, "workloads": m["workloads"] + [DEM]} if m["name"] in DEM_E2E else m


DEM_BENCH = {**BENCH, "workloads": BENCH["workloads"] + [
    {"name": DEM, "config": "merit3s-tile", "traffic": "dem", "chips": 1,
     "why": "from_dem"}],
    "end_to_end": [_listing_dem(m) for m in BENCH["end_to_end"]],
    "per_layer": BENCH["per_layer"] + [
        {"name": "fill_f1_ms", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "Device fill", "moves": "sweep_cells_per_s", "workloads": [DEM]},
        {"name": "idle_pct.dem", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "Device", "moves": "sweep_cells_per_s", "workloads": [DEM]}]}
TILT = {"shape": [96, 128],
        "dem": {**manifest.config(BENCH, "merit3s-tile")["dem"], "amp_m_at": [2048, 0.0]}}


@pytest.fixture
def device_fill(monkeypatch):
    import pyflwdir_torch.raster

    monkeypatch.setattr(pyflwdir_torch.raster, "_from_dem_engine", lambda dev, n: "device")


def _moved(call, x, j, prev):
    fl = call(x)
    fl._idxs_ds = fl._idxs_ds.copy()
    fl._idxs_ds[200] = 200  # an inland outlet where the cell drains
    return fl


def test_dem_cell_is_added_by_entries_alone():
    assert manifest.problems(DEM_BENCH) == []
    assert [m["name"] for m in DEM_BENCH["end_to_end"]] == [
        m["name"] for m in BENCH["end_to_end"]]
    e2e = [m["name"] for m in manifest.metrics_for(DEM_BENCH, "end_to_end", DEM)]
    assert sorted(e2e) == sorted(DEM_E2E + ("peak_mem_gib", "setup_s"))
    layers = manifest.metrics_for(DEM_BENCH, "per_layer", DEM)
    assert [m["name"] for m in layers] == ["fill_f1_ms", "idle_pct.dem"]
    assert all(m["moves"] in e2e for m in layers)


def test_from_dem_run(device_fill):
    res = _run(DEM, TILT, bench=DEM_BENCH)
    assert res["correct"] is True, res["checks"]
    # these three and no other (no seconds-a-call metric of its own)
    assert set(res["metrics"]) == set(DEM_E2E + ("peak_mem_gib", "setup_s"))
    for name in DEM_E2E:
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)
    res = _run(DEM, TILT, wrap=_moved, bench=DEM_BENCH)
    assert res["correct"] is False
