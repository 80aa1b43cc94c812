"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import os
import time

import pytest
import torch

from benchmark import cells, manifest
from benchmark.run import FORBIDDEN, forbidden_modules

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]


def test_names_units_and_files():
    assert manifest.problems(BENCH) == []


@pytest.mark.parametrize("name,ok", [
    ("merit3s-tile.up", True), ("idle_pct.sweep", True), ("_x", True), ("9a", True),
    ("a b", False), ("a/b", False), ("a,b", False), (".a", False), ("-a", False),
    ("a" * 65, False), ("µs", False)])
def test_name_characters(name, ok):
    assert bool(manifest.NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("Gcells/s", True), ("%", True), ("1/call", True), ("GiB", True),
    ("tokens per s", False), ("", False), ("x" * 17, False), ("µs", False)])
def test_unit_characters(unit, ok):
    assert bool(manifest.UNIT_RE.match(unit)) is ok


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_setup_bound():
    (setup,) = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup


def test_every_config_used_and_pairs_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    e2e = [m["name"] for m in manifest.metrics_for(BENCH, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = manifest.metrics_for(BENCH, "per_layer", cell)
    assert layers
    for m in layers:  # the metric it moves is reported in the cell
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    wl = manifest.workload(BENCH, cell)
    assert manifest.config(BENCH, wl["config"])["name"] == wl["config"]
    assert issubclass(cells.driver(manifest.traffic(wl["traffic"])["op"]), cells.Run)
    assert manifest.limits(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_by_name(metric):
    assert callable(manifest.reader(metric))


def test_run_seconds_fits_the_check_budget():
    # 2 + 14 runs a cell at run_seconds + 60 s each, 2 x 90 s of compile a
    # cell and 1200 s spare, with the full 24 cells, within 43,200 s
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_layer_names_agree():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    for name in layers:
        assert "\n" not in name and "\t" not in name and len(name) <= 200


def test_config_files_state_reductions():
    for c in BENCH["configs"]:
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg


@pytest.mark.parametrize("mods,found", [
    ({"jax": 0}, ["jax"]), ({"jax.numpy": 0}, ["jax"]), ({"jaxlib.xla": 0}, ["jaxlib"]),
    ({"pyflwdir_tpu.ops": 0}, ["pyflwdir_tpu"]), ({"flax.linen": 0}, ["flax"]),
    ({"pyflwdir_torch": 0, "pyflwdir_torch.ops": 0}, []), ({"jaxtyping": 0}, []),
    ({"pyflwdir_tpux": 0}, [])])
def test_forbidden_modules_by_whole_top_level_name(mods, found):
    assert forbidden_modules(mods) == found
    assert set(found) <= set(FORBIDDEN)


def test_spread_is_the_quartile_distance_over_the_median(tmp_path):
    from benchmark.spread import spread, table

    assert spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)
    for i, v in enumerate([10.0, 11.0, 12.0, 13.0]):
        line = {"metrics": {"m": {"value": v, "unit": "s"}}}
        (tmp_path / f"{i}.out").write_text("noise\n" + json.dumps(line) + "\n")
    med, sp, n = table(sorted(str(p) for p in tmp_path.iterdir()))["m"]
    assert (med, n) == (11.5, 4) and sp == pytest.approx((12.75 - 10.25) / 11.5)


# an op whose driver is found by file: ``checks/by_file`` holds its driver
# (``ops/upstream_cells.py``), its traffic and the cell's limits, and the
# lookup is pointed there; the cell is entries in the manifest alone
BY_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "by_file")
OP_CELL = "merit3s-tile.upstream_cells"
OP_BENCH = {
    **BENCH,
    "workloads": [{"name": OP_CELL, "config": "merit3s-tile", "traffic": "upstream_cells",
                   "chips": 1, "why": "one upstream_area() a step"}],
    "end_to_end": [{**m, "workloads": [OP_CELL]} if "workloads" in m else m
                   for m in BENCH["end_to_end"]],
    "per_layer": [{**m, "workloads": [OP_CELL]} for m in BENCH["per_layer"]
                  if m["name"] == "plan_build_s"]}


@pytest.fixture
def by_file(monkeypatch):
    for kind in ("workloads", "limits", "ops"):
        monkeypatch.setitem(manifest.DIRS, kind, os.path.join(BY_FILE, kind))


def _altered(call, x, j, prev):
    out = call(x).copy()
    out.reshape(-1)[7] += 1
    return out


def test_op_driver_found_by_file_runs_a_cell(by_file, small_tile_path):
    assert set(cells.DRIVERS) == set(manifest.BUILT_IN_OPS)
    assert "upstream_cells" not in manifest.BUILT_IN_OPS
    assert manifest.problems(OP_BENCH) == []
    assert issubclass(cells.driver("upstream_cells"), cells.Run)
    for wrap, correct in ((None, True), (_altered, False)):
        res, _ = cells.run_cell(OP_BENCH, OP_CELL, 2**31 + 19, 0.2, False, torch.device("cpu"),
                                time.perf_counter(), wrap=wrap,
                                overrides=small_tile_path["merit3s-tile"])
        assert res["correct"] is correct, res["checks"]
        assert set(res["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
        assert res["metrics"]["sweep_cells_per_s"]["value"] > 0


def test_op_without_a_driver_is_reported(by_file, tmp_path, monkeypatch):
    (tmp_path / "no_op.json").write_text('{"op": "no_such_op"}')
    (tmp_path / "not_a_run.json").write_text('{"op": "not_a_run"}')
    (tmp_path / "not_a_run.py").write_text("Driver = dict\n")
    monkeypatch.setitem(manifest.DIRS, "workloads", str(tmp_path))
    monkeypatch.setitem(manifest.DIRS, "ops", str(tmp_path))
    bench = {**OP_BENCH, "workloads": [{**OP_BENCH["workloads"][0], "traffic": "no_op"}]}
    assert manifest.problems(bench) == [f"{OP_CELL}: no driver for the op 'no_such_op'"]
    with pytest.raises(FileNotFoundError):
        cells.driver("no_such_op")
    with pytest.raises(TypeError):
        cells.driver("not_a_run")
