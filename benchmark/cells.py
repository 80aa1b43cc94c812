"""One run of one cell: set-up, the measured window, the comparison.

Every cell is a closed loop with one client: a step is dispatched, its
results stay on the card, the step ends with ``torch.cuda.synchronize()``,
and the next step follows at once. The traffic file names the operation a
step runs (``op``):

* ``up``: upward accumulations, ``FlwdirRaster._accumulate_dev`` on a raster
  configuration (``upstream_area()`` and ``accuflux()`` call it) or
  ``Flwdir._accumulate_dev`` on a network configuration;
* ``down``: downward path sums, ``TilePlan.accumulate_down`` of
  ``FlwdirRaster._tp_down()`` (what ``stream_distance()`` calls);
* ``from_dem``: ``pyflwdir_torch.from_dem`` on the set-up's DEM;
* any other op: the ``Driver`` class of ``benchmark/ops/<op>.py``
  (:func:`driver`), a :class:`Run` like those here; ``manifest.BUILT_IN_OPS``
  names the three above.

Every op reports the same end-to-end metrics: the rate, cells times
operations (a sweep, or one ``from_dem`` of the whole raster) completed over
the window, and the 95th percentile of the step walls.

The program under test is imported here, and in the drivers of
``benchmark/ops/``, and nowhere else in the benchmark.
"""

from __future__ import annotations

import gc
import json
import random
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import generate, manifest, reference, roofline
from .devtrace import Tracer

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Frame:
    """The two columns ``from_dataframe`` reads (the index and the
    downstream id), without pandas."""

    def __init__(self, ids, next_down):
        self.index = SimpleNamespace(values=ids)
        self._col = SimpleNamespace(values=next_down)

    def __getitem__(self, key):
        return self._col


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


class Run:
    """The state of one run; ``spans`` holds the set-up's host spans (s).

    A driver of an op is a subclass with these methods: ``setup()`` (inputs
    made from the seed, the program's state built, every shape warmed up;
    host spans by :meth:`timed`); ``step()``, one step of the window
    dispatched, each call wrapped by ``self.wrap(call, x, j, prev)``, its
    outputs returned in a list; ``units()``, the operations of a step over
    ``self.n`` cells each; ``release()``, the program's state freed;
    ``judge(kept)``, the numbers compared (a dict keyed as the cell's
    limits) for a step's outputs; ``control()``, the control's outputs of a
    step (read by ``calibrate.py`` alone); ``layer_context(ctx)``, ``ctx.n``
    and ``ctx.bytes`` (least bytes a call kind) set for the per-layer
    readers."""

    def __init__(self, cfg, traffic, seed, device, tracer, wrap=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        self.tracer = tracer
        self.wrap = wrap or (lambda call, x, j, prev: call(x))
        self.spans = {}

    def timed(self, name, fn):
        _sync(self.device)
        t = time.perf_counter()
        with self.tracer.span(name):
            out = fn()
        _sync(self.device)
        self.spans[name] = time.perf_counter() - t
        return out


# ---------------------------------------------------------------------------
# sweeps: up and down
# ---------------------------------------------------------------------------
class Sweeps(Run):
    """A step of ``sweeps_per_step`` sweeps over the traffic's fields in
    turn."""

    def setup(self):
        import pyflwdir_torch

        cfg, dev, seed = self.cfg, self.device, self.seed
        op = self.traffic["op"]

        def graph():
            if cfg["kind"] == "raster":
                return generate.scheidegger_d8(cfg["shape"], cfg["d8"]["choices"], seed, dev)
            codes, ds = generate.scheidegger_d8(cfg["raster_shape"], cfg["d8"]["choices"],
                                                seed, dev)
            del codes
            reach_ds, _ = generate.contract_reaches(ds)
            return None, reach_ds

        codes, self.ds = self.timed("generate_graph", graph)
        n = self.n = self.ds.numel()
        _log(f"nodes {n}")
        self.fields = self.timed("generate_fields", lambda: [
            generate.make_field(spec, n, seed, i, dev, ds=self.ds, shape=cfg.get("shape"),
                                geo=cfg.get("geo"))
            for i, spec in enumerate(self.traffic["fields"])])
        if cfg["kind"] == "raster":
            d8 = codes.cpu().numpy()
            del codes
            fl = self.timed("parse", lambda: pyflwdir_torch.from_array(d8, ftype="d8",
                                                                       device=dev))
            if op == "up":
                self.timed("plan_build", lambda: fl._tile_plan().arrays())
                self.call = fl._accumulate_dev
            else:
                tp = self.timed("plan_build", lambda: self._down_plan(fl))
                self.call = tp.accumulate_down
        else:
            k = np.arange(n, dtype=np.int64)
            rds = self.ds.cpu().numpy()
            ids = cfg["id_offset"] + k
            next_down = np.where(rds == k, 0, cfg["id_offset"] + rds)
            fl = self.timed("parse", lambda: pyflwdir_torch.from_dataframe(
                _Frame(ids, next_down), ds_col="NEXT_DOWN", device=dev))
            self.timed("plan_build", fl._accel)
            self.call = fl._accumulate_dev
        self.fl = fl
        self.kind = [f"{op}.{str(x.dtype).split('.')[-1]}" for x in self.fields]
        self.timed("warm_up", self.step)

    @staticmethod
    def _down_plan(fl):
        tp = fl._tp_down()
        tp.down_arrays()
        return tp

    def step(self):
        outs = []
        nf = len(self.fields)
        for j in range(int(self.traffic["sweeps_per_step"])):
            fi = j % nf
            with self.tracer.call(self.kind[fi]):
                outs.append(self.wrap(self.call, self.fields[fi], j, outs))
        return outs

    def units(self):
        return int(self.traffic["sweeps_per_step"])

    def release(self):
        del self.fl, self.call

    def judge(self, kept):
        op = self.traffic["op"]
        levels = reference.Levels(self.ds)
        refs = reference.reference_sweeps(levels, op, self.fields)
        nf, S = len(self.fields), int(self.traffic["sweeps_per_step"])
        kept = list(kept[:S]) + [None] * (S - len(kept))
        return reference.compare_sweeps(op, kept, [j % nf for j in range(S)], refs,
                                        self.fields)

    def control(self):
        """The control in the program's place: the reference summed one
        precision lower (float32 for the float fields), its results in the
        program's output dtypes, one a sweep of a step."""
        levels = reference.Levels(self.ds)
        refs = reference.reference_sweeps(levels, self.traffic["op"], self.fields,
                                          control=True)
        nf = len(self.fields)
        return [refs[j % nf].to(self.fields[j % nf].dtype)
                for j in range(int(self.traffic["sweeps_per_step"]))]

    def layer_context(self, ctx):
        ctx.n = self.n
        ctx.bytes = {}
        for x, kind in zip(self.fields, self.kind):
            ctx.bytes[kind] = roofline.sweep_bytes(self.cfg, self.n, x.dtype, x.dtype)


# ---------------------------------------------------------------------------
# from_dem
# ---------------------------------------------------------------------------
class FromDem(Run):
    """A step of one ``from_dem`` on the set-up's DEM."""

    def setup(self):
        import pyflwdir_torch

        cfg = self.cfg
        self.dem = self.timed("generate_dem", lambda: generate.relief_dem(
            cfg["shape"], cfg["dem"], self.device).cpu().numpy())
        self.n = self.dem.size
        self.from_dem = pyflwdir_torch.from_dem
        self.timed("warm_up", self.step)

    def step(self):
        with self.tracer.call("from_dem"):
            return [self.wrap(lambda z: self.from_dem(z, device=self.device), self.dem, 0, [])]

    def units(self):
        return 1

    def release(self):
        del self.from_dem

    def judge(self, kept):
        fl = kept[0]
        z = torch.as_tensor(self.dem, device=self.device)
        ds = torch.as_tensor(np.asarray(fl.idxs_ds, np.int64), device=self.device)
        del kept[:]
        counts = reference.judge_d8(z, ds)
        _log("d8 certificate: " + json.dumps(counts))
        return {"bad_cells": sum(counts.values())}

    def control(self):
        """The program's D8 of the DEM rounded to bfloat16, one precision
        below the DEM's float32: the program judged on the elevations it
        would see in that precision."""
        z = torch.as_tensor(self.dem).to(torch.bfloat16).to(torch.float32).numpy()
        return [self.from_dem(z, device=self.device)]

    def layer_context(self, ctx):
        ctx.n = self.n
        ctx.bytes = {}


#: the drivers of ``manifest.BUILT_IN_OPS``
DRIVERS = {"up": Sweeps, "down": Sweeps, "from_dem": FromDem}


def driver(op):
    """The driver of ``op``: :data:`DRIVERS`' entry for a built-in op, else
    the ``Driver`` of ``benchmark/ops/<op>.py`` (:func:`manifest.driver`)."""
    if op in manifest.BUILT_IN_OPS:
        return DRIVERS[op]
    cls = manifest.driver(op)
    if not (isinstance(cls, type) and issubclass(cls, Run)):
        raise TypeError(f"the Driver of the op {op!r} is not a cells.Run")
    return cls


def run_cell(bench, cell, seed, seconds, trace, device, t0, wrap=None, overrides=None,
             root=manifest.ROOT):
    """Run the cell ``cell`` of the manifest ``bench`` once; return the
    result line (a dict) and the checks (name -> (value, limit)).
    ``t0``: ``time.perf_counter()`` at the start of the process. ``wrap``:
    ``wrap(call, x, j, prev)`` in place of ``call(x)`` for the j-th call of
    a step (the tests break the timed path with it). ``overrides``: keys of
    the configuration replaced (the tests run at small sizes)."""
    wl = manifest.workload(bench, cell)
    cfg = {**manifest.config(bench, wl["config"], root), **(overrides or {})}
    traffic = manifest.traffic(wl["traffic"])
    lim = manifest.limits(cell)
    tracer = Tracer(trace)
    run = driver(traffic["op"])(cfg, traffic, seed, device, tracer, wrap)
    run.setup()
    setup_s = time.perf_counter() - t0
    _log("set-up (s): " + json.dumps({k: round(v, 4) for k, v in run.spans.items()}))

    # the window: a closed loop of one client
    pick = random.Random(int(seed))
    times, steps, kept = [], 0, None
    with tracer.window():
        start = time.perf_counter()
        while True:
            ts = time.perf_counter()
            with tracer.span("step"):
                outs = run.step()
                with tracer.span("sync"):
                    _sync(device)
            te = time.perf_counter()
            times.append(te - ts)
            steps += 1
            if pick.random() * steps < 1:  # a uniform sample of the window's steps
                kept = outs
            del outs
            if te - start >= seconds:
                break
    window = te - start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    run.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tj = time.perf_counter()
    numbers = run.judge(kept)
    del kept
    _log(f"comparison {time.perf_counter() - tj:.3f} s")
    checks = {k: (numbers[k], lim[k]) for k in lim}
    correct = all(v <= limit for v, limit in checks.values()) and set(numbers) == set(lim)

    units = steps * run.units()
    values = {
        "setup_s": setup_s,
        "peak_mem_gib": peak / 2**30,
        "sweep_cells_per_s": run.n * units / window / 1e9,
        "step_p95_ms": float(np.percentile(np.asarray(times) * 1e3, 95)),
    }
    q = np.percentile(np.asarray(times) * 1e3, [50, 90, 95, 99, 100])
    _log(f"window {window:.4f} s, {steps} steps; step ms p50 / p90 / p95 / p99 / max "
         + " / ".join(f"{v:.4f}" for v in q))

    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": units, "failed": 0}
    if trace:
        s = tracer.summary
        ctx = SimpleNamespace(cell=cell, cfg=cfg, traffic=traffic, op=traffic["op"],
                              spans=run.spans, summary=s, device_name=dev_info["kind"],
                              steps=steps)
        run.layer_context(ctx)
        metrics = {}
        for m in manifest.metrics_for(bench, "per_layer", cell):
            v = manifest.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if s is not None:
            dev_info["busy_s"] = s["busy_s"]
            dev_info["window_s"] = s["window_s"]
            result["breakdown"] = {"device_ops": [list(x) for x in s["device_ops"]],
                                   "idle_gaps": [list(x) for x in s["idle_gaps"]]}
            _log("trace: " + json.dumps({k: s[k] for k in ("calls", "syncs", "launches",
                                                          "recorded")}))
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.metrics_for(bench, "end_to_end", cell)
                   if m["name"] in values}
    result["metrics"] = metrics
    result["device"] = dev_info
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    return result, checks

