"""Spans of the benchmark and the reading of the profiler's device trace.

The benchmark marks its own calls into the program with spans
(``torch.profiler.record_function`` ranges named ``bench:<name>``); in a
traced run the window runs under ``torch.profiler.profile`` (CPU and CUDA
activity) and :func:`summarize` reads the events:

* every device operation (kernel, copy, set), attributed to the call span
  whose CUDA runtime call launched it (by correlation id);
* the host-blocking runtime calls inside each call span;
* the union of device activity over the traced window, and the idle gaps
  between, each named by the innermost span the host was in.

:func:`per_call_ms` is a frozen copy of the arithmetic of ``_device_ms`` in
``chip_smoke.py`` (commit 5958bf7): a trace often comes back short of kernel
records, so a kernel's time per call is its mean duration times its launches
per call, rounded up from records / calls, never the sum over the records
divided by the calls.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

PREFIX = "bench:"
CALL = PREFIX + "call:"
#: CUDA runtime calls that block the host until the device catches up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
#: CUDA runtime calls that put one operation on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
                "cudaMemset")


def per_call_ms(total_us, records, most, calls):
    """Device ms of one call from a trace of ``calls`` calls: ``total_us``,
    ``records`` and ``most`` map each operation to its summed duration, its
    records over the traces and its records in the fullest trace (frozen
    from ``chip_smoke.py`` ``_device_ms``)."""
    return sum(total_us[k] / records[k] * -(-most[k] // calls) for k in records) / 1e3


class Tracer:
    """Spans for the benchmark's calls; with ``enabled``, the profiler over
    the window (:meth:`window`) and its summary (:attr:`summary`)."""

    def __init__(self, enabled):
        self.enabled = bool(enabled)
        self.summary = None

    def span(self, name):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def call(self, kind):
        """The span of one call into the program, of the kind ``kind``."""
        return self.span(CALL[len(PREFIX):] + kind)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with self.span("window"):
                yield
        self.summary = summarize(prof.profiler.kineto_results.events())


def _is_device(e):
    return str(e.device_type()).split(".")[-1] != "CPU"


def _merge(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events):
    """The numbers the per-layer readers take from one traced window (times
    in seconds, on the trace's clock)."""
    spans, runtime, device = [], [], []
    for e in events:
        name = e.name()
        if _is_device(e):
            if not name.startswith(PREFIX):
                device.append((e.start_ns(), e.duration_ns(), name, e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name[len(PREFIX):]))
        elif name.startswith("cu"):
            runtime.append((e.start_ns(), name, e.correlation_id()))
    win = [s for s in spans if s[2] == "window"]
    if not win:
        return None
    w0, w1 = win[0][0], win[0][1]

    calls = sorted((s for s in spans if s[2].startswith("call:")), key=lambda s: s[0])
    starts = [s[0] for s in calls]

    def call_of(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= calls[i][1]:
            return calls[i][2][len("call:"):]
        return None

    n_calls = defaultdict(int)
    for s in calls:
        n_calls[s[2][len("call:"):]] += 1
    launch_kind, syncs, launches = {}, defaultdict(int), defaultdict(int)
    for t, name, corr in runtime:
        kind = call_of(t)
        if kind is None:
            continue
        if name in SYNC_CALLS:
            syncs[kind] += 1
        if name in LAUNCH_CALLS:
            launches[kind] += 1
        launch_kind[corr] = kind
    ops = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))  # kind -> name -> [us, n]
    by_name = defaultdict(float)
    intervals = []
    recorded = defaultdict(int)
    for t, dur, name, corr in device:
        intervals.append((max(t, w0), min(t + dur, w1)))
        by_name[name] += dur / 1e9
        kind = launch_kind.get(corr)
        if kind is not None:
            rec = ops[kind][name]
            rec[0] += dur / 1e3
            rec[1] += 1
            recorded[kind] += 1
    busy = _merge([iv for iv in intervals if iv[1] > iv[0]])
    busy_ns = sum(e - s for s, e in busy)

    # idle gaps inside the window, named by the innermost span around them
    # (spans nest, so the innermost around a time is the latest-starting
    # span that has not ended; a step holds a few dozen spans)
    nested = sorted((s for s in spans if s[2] != "window"), key=lambda s: s[0])
    nstarts = [s[0] for s in nested]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = "window"
        last = bisect.bisect_right(nstarts, mid) - 1
        for j in range(last, max(last - 64, -1), -1):
            if nested[j][1] >= mid:
                inner = nested[j][2]
                break
        gaps[inner] += (b - a) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "calls": dict(n_calls),
        "ops": {k: {n: tuple(v) for n, v in d.items()} for k, d in ops.items()},
        "syncs": dict(syncs),
        "launches": dict(launches),
        "recorded": dict(recorded),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }


def kind_ms(summary, kind):
    """Device ms of one call of ``kind`` from a window's summary (every call
    of a kind launches the same operations: :func:`per_call_ms`), or None."""
    if summary is None or kind not in summary["ops"]:
        return None
    ops = summary["ops"][kind]
    total = {k: v[0] for k, v in ops.items()}
    records = {k: v[1] for k, v in ops.items()}
    return per_call_ms(total, records, records, summary["calls"][kind])


def kinds(summary, prefix):
    """The call kinds of the summary that start with ``prefix``."""
    if summary is None:
        return []
    return [k for k in summary["calls"] if k.startswith(prefix)]


def sweep_ms(ctx, op, graph_kind):
    """Device ms per ``op`` sweep call on a ``graph_kind`` configuration
    (``raster`` or ``network``), averaged over the traced window's calls of
    every kind; None in another cell or without device records."""
    if ctx.cfg["kind"] != graph_kind or ctx.op != op:
        return None
    s = ctx.summary
    total, calls = 0.0, 0
    for k in kinds(s, op + "."):
        ms = kind_ms(s, k)
        if ms is None:
            return None
        total += ms * s["calls"][k]
        calls += s["calls"][k]
    return total / calls if calls else None
