"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration ``<c>``: ``benchmark/configs/<c>.json``, the file its
  entry's ``file`` names;
* a traffic mix ``<t>``: ``benchmark/workloads/<t>.json``, whose ``op``
  names the operation a step runs;
* a cell's limits: ``benchmark/limits/<cell>.json``;
* a per-layer metric ``<m>``: ``benchmark/metrics/<m>.py``, a module with a
  function ``read(ctx)`` that returns the metric's value or None;
* the driver of an op ``<op>`` outside :data:`BUILT_IN_OPS`:
  ``benchmark/ops/<op>.py``, a module with a class ``Driver``, a
  ``cells.Run``.

A new cell, configuration, traffic mix, op or metric is a new file and an
entry in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: where a file of each kind is found: ``<DIRS[kind]>/<name><suffix>``
DIRS = {kind: os.path.join(HERE, kind) for kind in ("workloads", "limits", "metrics", "ops")}
_SUFFIX = {"workloads": ".json", "limits": ".json", "metrics": ".py", "ops": ".py"}

#: the ops whose drivers ``cells.DRIVERS`` holds; any other op's driver is a
#: file of ``ops/``
BUILT_IN_OPS = ("up", "down", "from_dem")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _entry(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest, name):
    return _entry(manifest["workloads"], name, "workload")


def config(manifest, name, root=ROOT):
    entry = _entry(manifest["configs"], name, "config")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def path(kind, name):
    """The file of ``kind`` (a key of :data:`DIRS`) named ``name``."""
    return os.path.join(DIRS[kind], name + _SUFFIX[kind])


def traffic(name):
    with open(path("workloads", name)) as f:
        return json.load(f)


def limits(cell):
    """Each number compared in the cell ``cell``, with its limit."""
    with open(path("limits", cell)) as f:
        return json.load(f)


def metrics_for(manifest, section, cell):
    """The ``section`` metrics (``end_to_end`` or ``per_layer``) that the
    cell ``cell`` reports."""
    return [m for m in manifest[section] if cell in m.get("workloads", [cell])]


def _module(kind, name):
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path(kind, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name):
    """The ``read`` function of the per-layer metric ``name``."""
    return _module("metrics", name).read


def driver(op):
    """The ``Driver`` class of the op ``op`` (outside :data:`BUILT_IN_OPS`),
    from ``ops/<op>.py``."""
    return _module("ops", op).Driver


def problems(manifest, root=ROOT):
    """What in the manifest breaks the benchmark's naming rules or names a
    file that is not there (an empty list when nothing does)."""
    out = []
    names = {}
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for it in manifest[sec]:
            n = it["name"]
            if not NAME_RE.match(n):
                out.append(f"{sec}: bad name {n!r}")
            key = "metric" if sec in ("end_to_end", "per_layer") else sec
            if (key, n) in names:
                out.append(f"{sec}: {n!r} twice")
            names[(key, n)] = it
            if "unit" in it and not UNIT_RE.match(it["unit"]):
                out.append(f"{n}: bad unit {it['unit']!r}")
    for c in manifest["configs"]:
        for k in c.get("reduced", []):
            if not NAME_RE.match(k):
                out.append(f"{c['name']}: bad reduced key {k!r}")
        if not os.path.exists(os.path.join(root, c["file"])):
            out.append(f"{c['name']}: no file {c['file']}")
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME_RE.match(w[key]):
                out.append(f"{w['name']}: bad {key} {w[key]!r}")
        if not os.path.exists(path("limits", w["name"])):
            out.append(f"{w['name']}: no limits")
        if not os.path.exists(path("workloads", w["traffic"])):
            out.append(f"{w['name']}: no traffic file for {w['traffic']!r}")
            continue
        op = traffic(w["traffic"])["op"]
        if op not in BUILT_IN_OPS and not os.path.exists(path("ops", op)):
            out.append(f"{w['name']}: no driver for the op {op!r}")
    for m in manifest["per_layer"]:
        if not os.path.exists(path("metrics", m["name"])):
            out.append(f"{m['name']}: no reader")
    return out
