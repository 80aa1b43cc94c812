"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration ``<c>``: ``benchmark/configs/<c>.json``, the file its
  entry's ``file`` names;
* a traffic mix ``<t>``: ``benchmark/workloads/<t>.json``;
* a per-layer metric ``<m>``: ``benchmark/metrics/<m>.py``, a module with a
  function ``read(ctx)`` that returns the metric's value or None.

A new cell, configuration, traffic mix or metric is a new file and an entry
in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

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


def traffic(name):
    with open(os.path.join(HERE, "workloads", f"{name}.json")) as f:
        return json.load(f)


def metrics_for(manifest, section, cell):
    """The ``section`` metrics (``end_to_end`` or ``per_layer``) that the
    cell ``cell`` reports."""
    return [m for m in manifest[section] if cell in m.get("workloads", [cell])]


def reader(name):
    """The ``read`` function of the per-layer metric ``name``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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
        if not os.path.exists(os.path.join(HERE, "workloads", f"{w['traffic']}.json")):
            out.append(f"{w['name']}: no traffic file for {w['traffic']!r}")
    for m in manifest["per_layer"]:
        if not os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py")):
            out.append(f"{m['name']}: no reader")
    return out
