"""Spans and counters of the port: where the host spends a sweep call and a
plan build, and the blocking reads it makes.

Tracing is off by default (:func:`enable`, :func:`disable`). While it is
off, :func:`span` returns one shared null context. While it is on, a span
opens a profiler range named ``pf:<name>`` (PyTorch's ``RecordFunction``,
the range ``torch.profiler.record_function`` opens, in its fast form
where PyTorch has it, which skips the operator dispatcher). Under
``torch.profiler`` the ranges lie on the device trace's clock beside the
CUDA runtime calls, so a reader can attribute each device operation (by
correlation id) and each idle stretch of the device to the innermost
program span. Where no profiler runs (the set-up), a span also appends
``(name, parent, start_ns, end_ns)`` to :func:`records` (host clock,
``time.perf_counter_ns``; ``parent`` the name of the recorded span around
it, or None). :func:`timed` is a span that times the host whether tracing
is on or off (``.seconds`` after it closes) and is always recorded while
tracing is on: the plan build's ``build_seconds`` and ``upload_seconds``
come from it.

Span names:

* a sweep call: ``up`` (``TilePlan.accumulate``, ``BigAccelPlan.accumulate``)
  or ``down`` (``TilePlan.accumulate_down``), and inside them ``dtype``
  (``ops.accel.acc_dtype``, with its range read of 64-bit integer data),
  ``cast`` (the data's ``.to()`` in and out, :func:`cast`; a float32
  downward call on tiles has none), the stages by the kernels
  they launch: ``T1``, ``coarse``, ``T2`` upward on tiles, ``T3``,
  ``coarse``, ``T4`` downward, ``H1``, ``H2``, ``H3`` on a router plan (the
  tile plan's coarse level too);
* a plan build: ``plan.phase1``, ``plan.far_tables``, ``plan.exit_tables``,
  ``plan.coarse_graph``, ``plan.coarse_plan``, ``plan.replay`` (a JAX
  plan's chains), ``plan.upload``, ``plan.down.sort``,
  ``plan.down.compose``, ``plan.down.coarse``, ``plan.down.upload``;
  ``parse`` (``from_dataframe``), ``plan.dfs``, ``plan.accel``,
  ``plan.big``; ``native.<function>`` for each call into the native host
  library (``pyflwdir_torch.runtime``); ``kernels.load``.

Counters, always on: :data:`host_reads`, the blocking device-to-host reads
of the sweep and plan code by site (:func:`host_ints`); :data:`casts`, the
dtype conversions of the sweep calls by site; and ``kernels.launches``, the
kernel launches, which :func:`counters` reads beside them.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch

__all__ = ["enable", "disable", "span", "timed", "records", "reset", "host_reads", "host_ints",
           "casts", "cast", "counters"]

_PREFIX = "pf:"

try:  # the profiler's range without the dispatcher round trip of record_function
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # pragma: no cover - older PyTorch
    _Range = torch.profiler.record_function
_profiling = torch._C._autograd._profiler_enabled

#: blocking device-to-host reads by site (``acc_dtype``, ``accumulate_dev``,
#: ``cast_checked``)
host_reads = Counter()
#: dtype conversions of the sweep calls by site: ``<op>.copy`` (``up`` or
#: ``down``) each ``.to()`` of :func:`cast` that changed the dtype, so
#: launched a copy on the card; ``down.fused`` each float32 downward call on
#: tiles whose conversions T3 and T4 made as they read and wrote
casts = Counter()

_on = False
_NULL = contextlib.nullcontext()
_records = []
_open = []  # names of the open spans, innermost last


def enable():
    """Turn tracing on: spans open profiler ranges and are recorded."""
    global _on
    _on = True


def disable():
    """Turn tracing off (the default)."""
    global _on
    _on = False


class _Span:
    """A span that times the host; while tracing is on, also a profiler
    range and a record."""

    __slots__ = ("name", "seconds", "_range", "_parent", "_t0")

    def __init__(self, name):
        self.name = name
        self.seconds = None

    def __enter__(self):
        self._range = None
        if _on:
            self._parent = _open[-1] if _open else None
            _open.append(self.name)
            self._range = _Range(_PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) / 1e9
        if self._range is not None:
            self._range.__exit__(*exc)
            _open.pop()
            _records.append((self.name, self._parent, self._t0, t1))
        return False


def span(name):
    """The span ``name``: the shared null context while tracing is off; the
    profiler's range alone while a profiler runs (the profiler keeps it, so
    :func:`records` does not, and the span costs no Python frames of its
    own)."""
    if not _on:
        return _NULL
    return _Range(_PREFIX + name) if _profiling() else _Span(name)


def timed(name):
    """The span ``name``, timing the host (``.seconds``) even while tracing
    is off."""
    return _Span(name)


def records():
    """The recorded spans, ``(name, parent, start_ns, end_ns)`` in the order
    they closed."""
    return list(_records)


def reset():
    """Empty :func:`records`."""
    _records.clear()


def host_ints(site, *tensors):
    """The one-element ``tensors`` as Python ints: a blocking read each on
    the card, counted under ``site`` in :data:`host_reads`."""
    host_reads[site] += len(tensors)
    return [int(t) for t in tensors]


def cast(t, dtype, op):
    """``t.to(dtype)`` in the span ``cast`` of the sweep call ``op``, a
    conversion counted under ``<op>.copy`` in :data:`casts`."""
    with span("cast"):
        if t.dtype != dtype:
            casts[op + ".copy"] += 1
        return t.to(dtype)


def counters():
    """A snapshot of the counters: ``{"host_reads": {site: n}, "casts":
    {site: n}, "launches": {kernel: n}}`` (``kernels.launches`` read where
    it is kept)."""
    from . import kernels

    return {"host_reads": dict(host_reads), "casts": dict(casts),
            "launches": dict(kernels.launches)}
