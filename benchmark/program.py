"""The program's own spans in a traced window, read beside the benchmark's.

With ``pyflwdir_torch.trace.enable()`` the program opens a profiler range
``pf:<name>`` wherever it does a named piece of work: a sweep call (``up``,
``down``), its dispatch (``dtype``: the accumulation dtype and its range read
to the host; ``cast``: the data's ``.to()`` in and out), its stages named by
the kernels they launch (``T1``, ``coarse``, ``T2``; ``T3``, ``coarse``,
``T4``; ``H1``, ``H2``, ``H3``) and, in set-up, the plan build's phases
(``plan.*``, ``native.*``, ``parse``, ``kernels.load``), which it also keeps
on the host clock (``trace.records()``).

:func:`summarize` reads a window's profiler events as ``devtrace.summarize``
reads the benchmark's spans, per program span name: the calls, the host
seconds inclusive and self, the device operations attributed by correlation
id to the innermost program span whose runtime call launched them, the
host-blocking runtime calls, and the device's idle time, each stretch of
it given to the innermost program span the host was in (``None``: outside
every program span; a gap the host spent partly in the range read and
partly launching the next kernel is split between the two: a gap given
whole to the span around its midpoint, as ``devtrace`` names the
benchmark's, swung the split by 3 points of the window from run to run).
:func:`layer_metrics` turns that, the counters' deltas over the window and
the set-up's records into the per-layer numbers of ``PERF.md`` §3.
:func:`bench_events` drops the device-side copies of the program's ranges
(a profiler may mirror a range onto the device timeline), so that
``devtrace.summarize`` reads the same with the program's spans on as off.

Nothing here imports the program. ``tools/trace_cell.py`` runs a cell with
it; ``PERF.md`` §7 says which edits of ``devtrace.py`` and ``cells.py`` would
report the numbers in every traced run.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from .devtrace import CALL, PREFIX, SYNC_CALLS, _merge, per_call_ms

PF = "pf:"
#: program spans whose self time is the call's dispatch
DISPATCH = ("up", "down", "dtype", "cast")
#: program spans of a sweep call's stages, named by the kernels they launch
STAGES = ("T1", "T2", "T3", "T4", "H1", "H2", "H3", "coarse")
#: program spans of a whole sweep call
CALLS = ("up", "down")


def _is_device(e):
    return str(e.device_type()).split(".")[-1] != "CPU"


def bench_events(events):
    """``events`` without device-side copies of program ranges: what
    ``devtrace.summarize`` reads as with the program's spans off."""
    return [e for e in events if not (_is_device(e) and e.name().startswith(PF))]


class _Spans:
    """Properly nested host spans ``(start, end, name)``; :meth:`at` finds
    the innermost one around a time."""

    def __init__(self, spans):
        self.s = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.s]
        self.parent = []
        stack = []
        for i, (a, b, _) in enumerate(self.s):
            while stack and self.s[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        """Index of the innermost span around time ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.s[i][1] < t:
            i = self.parent[i]
        return i

    def up_to(self, i, names):
        """The nearest of span ``i`` and its ancestors named in ``names``,
        or -1."""
        while i >= 0 and self.s[i][2] not in names:
            i = self.parent[i]
        return i


def summarize(events):
    """The program's spans in one traced window (seconds, the trace's
    clock), or None without a ``bench:window`` span:

    * ``spans``: per program span name, ``calls``, ``host_s`` (inclusive),
      ``self_s`` (less the program spans inside it), ``device_s`` (the
      operations it launched), ``sync_s`` (its host-blocking runtime calls)
      and ``idle_s`` (the device's idle time inside the window while it was
      the host's innermost program span);
    * ``ops``: per program span name, per device operation, ``(us, n)``;
    * ``aux_ops``: per call kind (the benchmark's ``call:<kind>`` spans),
      the operations of ``dtype`` and ``cast``, ``{name: (us, n)}``;
    * ``idle_outside_s``: idle time outside every program span;
    * ``blocked_s``: host-blocking runtime calls inside sweep calls;
    * ``window_s``, ``busy_s``, as ``devtrace.summarize`` has them.
    """
    prog, calls, runtime, device = [], [], [], []
    w0 = w1 = None
    for e in events:
        name = e.name()
        if _is_device(e):
            if not name.startswith((PREFIX, PF)):
                device.append((e.start_ns(), e.duration_ns(), name, e.correlation_id()))
            continue
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        if name.startswith(PF):
            prog.append((t0, t1, name[len(PF):]))
        elif name.startswith(CALL):
            calls.append((t0, t1, name[len(CALL):]))
        elif name == PREFIX + "window":
            w0, w1 = t0, t1
        elif name.startswith("cu"):
            runtime.append((t0, e.duration_ns(), name, e.correlation_id()))
    if w0 is None:
        return None
    sp, bc = _Spans(prog), _Spans(calls)

    per = defaultdict(lambda: dict(calls=0, host_s=0.0, self_s=0.0, device_s=0.0, sync_s=0.0,
                                   idle_s=0.0))
    for i, (a, b, name) in enumerate(sp.s):
        per[name]["calls"] += 1
        per[name]["host_s"] += (b - a) / 1e9
        per[name]["self_s"] += (b - a) / 1e9
        if sp.parent[i] >= 0:
            per[sp.s[sp.parent[i]][2]]["self_s"] -= (b - a) / 1e9

    launched, blocked = {}, 0.0
    for t, dur, name, corr in runtime:
        i = sp.at(t)
        if i < 0:
            continue
        launched[corr] = (sp.s[i][2], bc.at(t))
        if name in SYNC_CALLS:
            per[sp.s[i][2]]["sync_s"] += dur / 1e9
            if sp.up_to(i, CALLS) >= 0:
                blocked += dur / 1e9

    ops = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    aux = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    intervals = []
    for t, dur, name, corr in device:
        intervals.append((max(t, w0), min(t + dur, w1)))
        if corr not in launched:
            continue
        span, k = launched[corr]
        per[span]["device_s"] += dur / 1e9
        rec = ops[span][name]
        rec[0] += dur / 1e3
        rec[1] += 1
        if span in ("dtype", "cast") and k >= 0:
            rec = aux[bc.s[k][2]][name]
            rec[0] += dur / 1e3
            rec[1] += 1
    busy, outside = _merge([iv for iv in intervals if iv[1] > iv[0]]), 0.0
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    marks = sorted({t for a, b, _ in sp.s for t in (a, b)})
    for a, b in zip(edges[0::2], edges[1::2]):
        # a gap's stretches between the program spans' edges, each to the
        # innermost span the host was in
        cuts = [a, *marks[bisect.bisect_right(marks, a):bisect.bisect_left(marks, b)], b]
        for x, y in zip(cuts, cuts[1:]):
            if y <= x:
                continue
            i = sp.at((x + y) / 2)
            if i < 0:
                outside += (y - x) / 1e9
            else:
                per[sp.s[i][2]]["idle_s"] += (y - x) / 1e9
    return {
        "spans": {k: dict(v) for k, v in per.items()},
        "ops": {k: {n: tuple(v) for n, v in d.items()} for k, d in ops.items()},
        "aux_ops": {k: {n: tuple(v) for n, v in d.items()} for k, d in aux.items()},
        "idle_outside_s": outside,
        "blocked_s": blocked,
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
    }


def gaps(prog):
    """The idle time by innermost program span, largest first, ``None`` for
    the time outside every program span: ``[(name, seconds)]``."""
    out = [(k, v["idle_s"]) for k, v in prog["spans"].items() if v["idle_s"] > 0]
    out.append((None, prog["idle_outside_s"]))
    return sorted(out, key=lambda kv: -kv[1])


def _window_delta(c0, c1, key):
    return sum(c1[key].values()) - sum(c0[key].values())


def setup_seconds(records, names):
    """Seconds of the set-up's records (``trace.records()``: ``(name,
    parent, start_ns, end_ns)``) whose name starts with one of ``names``
    and that lie inside a ``plan.*`` record: the plan build."""
    plan = [(a, b) for n, _, a, b in records if n.startswith("plan.")]
    return sum((b - a) / 1e9 for n, _, a, b in records
               if n.startswith(names) and any(pa <= a and b <= pb for pa, pb in plan))


def layer_metrics(prog, summary, counters, records):
    """The per-layer numbers of the program's spans and counters, by name
    (None where a number has nothing to read): ``prog`` from
    :func:`summarize`, ``summary`` from ``devtrace.summarize``, ``counters``
    the program's counters ``(before, after)`` the window
    (``trace.counters()``), ``records`` the set-up's ``trace.records()``."""
    out = dict.fromkeys(("idle_pct.dispatch", "idle_pct.launch", "host_us_per_call",
                         "host_reads_per_call", "launches_per_call", "aux_device_ms",
                         "plan_native_s", "plan_upload_s"))
    if records:
        out["plan_native_s"] = setup_seconds(records, ("native.",))
        out["plan_upload_s"] = setup_seconds(records, ("plan.upload", "plan.down.upload"))
    if prog is None or summary is None:
        return out
    sp = prog["spans"]
    n = sum(sp[k]["calls"] for k in CALLS if k in sp)
    if not n or prog["window_s"] <= 0:
        return out
    idle = {k: v["idle_s"] for k, v in sp.items()}
    w = prog["window_s"]
    out["idle_pct.dispatch"] = 100.0 * sum(idle.get(k, 0.0) for k in DISPATCH) / w
    out["idle_pct.launch"] = 100.0 * sum(idle.get(k, 0.0) for k in STAGES) / w
    host = sum(sp[k]["host_s"] for k in CALLS if k in sp)
    out["host_us_per_call"] = (host - prog["blocked_s"]) / n * 1e6
    if counters is not None:
        c0, c1 = counters
        out["host_reads_per_call"] = _window_delta(c0, c1, "host_reads") / n
        out["launches_per_call"] = _window_delta(c0, c1, "launches") / n
    kinds = {k: c for k, c in summary["calls"].items() if c}
    total = 0.0
    for k, ops in prog["aux_ops"].items():
        if k in kinds:
            rec = {o: v[1] for o, v in ops.items()}
            total += per_call_ms({o: v[0] for o, v in ops.items()}, rec, rec, kinds[k]) * kinds[k]
    out["aux_device_ms"] = total / sum(kinds.values()) if kinds else None
    return out
