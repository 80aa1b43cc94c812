"""The program's spans read beside the benchmark's, on a synthetic window.

Two sweep calls (an int32 one whose range read blocks the host, a float64
one) with the program's spans (``pf:``) inside the benchmark's, their
runtime calls and device operations: ``devtrace.summarize`` reads the same
with and without the program's spans, and ``program.summarize`` gives
device operations and idle time to the innermost program span (counted one
nanosecond at a time for the reference), so that the dispatch, launch and
outside shares add up to ``idle_pct.sweep``."""

import math

import pytest

from benchmark import devtrace, manifest, program


class Ev:
    """A profiler event as ``kineto_results.events()`` hands it over."""

    def __init__(self, name, start, end, device=False, corr=0):
        self._n, self._s, self._d, self._dev, self._c = name, start, end - start, device, corr

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c


def _bench():
    return [Ev("bench:window", 0, 1000), Ev("bench:step", 0, 990),
            Ev("bench:call:up.int32", 10, 400), Ev("bench:call:up.float64", 400, 800),
            Ev("bench:sync", 800, 990),
            Ev("cudaStreamSynchronize", 801, 985, corr=99)]


def _program_host():
    return [Ev(f"pf:{n}", a, b) for n, a, b in (
        ("up", 12, 398), ("dtype", 14, 120), ("cast", 121, 125), ("T1", 130, 200),
        ("coarse", 200, 300), ("H1", 210, 240), ("H2", 240, 270), ("H3", 270, 290),
        ("T2", 300, 390), ("cast", 390, 395),
        ("up", 402, 700), ("dtype", 403, 404), ("cast", 405, 406), ("T1", 410, 500),
        ("coarse", 500, 590), ("H1", 505, 530), ("H2", 530, 560), ("H3", 560, 580),
        ("T2", 590, 690), ("cast", 690, 695))]


# (runtime call, its start, its end, correlation id, the device operation
# it launched, the operation's start and end); None: no operation
_LAUNCHES = (
    ("cudaLaunchKernel", 20, 22, 1, "reduce_kernel", 25, 60),
    ("cudaMemcpyAsync", 30, 32, 2, "Memcpy DtoH", 61, 65),
    ("cudaStreamSynchronize", 33, 110, 3, None, 0, 0),
    ("cudaLaunchKernel", 135, 137, 4, "tile_pass_a", 140, 260),
    ("cudaLaunchKernel", 215, 217, 5, "accel_in_scan", 262, 280),
    ("cudaLaunchKernel", 245, 247, 6, "accel_near_out", 281, 300),
    ("cudaLaunchKernel", 275, 277, 7, "accel_far_merge", 300, 310),
    ("cudaLaunchKernel", 305, 307, 8, "tile_pass_c", 320, 500),
    ("cudaLaunchKernel", 415, 417, 9, "tile_pass_a", 505, 600),
    ("cudaLaunchKernel", 510, 512, 10, "accel_in_scan", 600, 610),
    ("cudaLaunchKernel", 535, 537, 11, "accel_near_out", 615, 620),
    ("cudaLaunchKernel", 565, 567, 12, "accel_far_merge", 620, 640),
    ("cudaLaunchKernel", 595, 597, 13, "tile_pass_c", 700, 780),
)


def _runtime_and_device():
    out = []
    for call, a, b, corr, op, s, e in _LAUNCHES:
        out.append(Ev(call, a, b, corr=corr))
        if op is not None:
            out.append(Ev(op, s, e, device=True, corr=corr))
    return out


def _events(host_spans=True, device_copies=False):
    ev = _bench() + _runtime_and_device()
    if host_spans:
        ev += _program_host()
    if device_copies:  # ranges mirrored onto the device timeline
        ev += [Ev("pf:up", 25, 500, device=True), Ev("pf:up", 505, 780, device=True)]
    return ev


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize("device_copies", [False, True])
def test_bench_summary_reads_the_same_with_program_spans(device_copies):
    base = devtrace.summarize(_events(host_spans=False))
    ev = _events(device_copies=device_copies)
    _same(devtrace.summarize(program.bench_events(ev)), base)
    if not device_copies:
        _same(devtrace.summarize(ev), base)


def test_device_operations_go_to_the_innermost_program_span():
    prog = program.summarize(_events(device_copies=True))
    sp = prog["spans"]
    assert sp["up"]["calls"] == 2 and sp["cast"]["calls"] == 4
    assert sp["T1"]["device_s"] == pytest.approx((120 + 95) / 1e9)
    assert sp["T2"]["device_s"] == pytest.approx((180 + 80) / 1e9)
    assert sp["H1"]["device_s"] == pytest.approx((18 + 10) / 1e9)
    assert sp["coarse"]["device_s"] == 0  # its kernels belong to H1, H2, H3
    assert sp["dtype"]["device_s"] == pytest.approx((35 + 4) / 1e9)
    assert sorted(prog["ops"]["dtype"]) == ["Memcpy DtoH", "reduce_kernel"]
    # self time: the call less its dispatch and stage spans
    assert sp["up"]["self_s"] == pytest.approx((386 - 106 - 4 - 70 - 100 - 90 - 5
                                                + 298 - 1 - 1 - 90 - 90 - 100 - 5) / 1e9)
    assert sp["dtype"]["sync_s"] == pytest.approx(77 / 1e9)
    assert prog["blocked_s"] == pytest.approx(77 / 1e9)  # the step's sync lies outside


def _idle_by_span_ns(events):
    """Idle nanoseconds of the window by the host's innermost program span,
    counted one nanosecond at a time (None: outside every program span)."""
    busy = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.device_type().endswith("CUDA") and not e.name().startswith("pf:")]
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[3:]) for e in events
             if not e.device_type().endswith("CUDA") and e.name().startswith("pf:")]
    out = {}
    for t in range(1000):
        m = t + 0.5
        if any(a <= m < b for a, b in busy):
            continue
        around = [s for s in spans if s[0] <= m <= s[1]]
        name = max(around, key=lambda s: (s[0], -s[1]))[2] if around else None
        out[name] = out.get(name, 0) + 1
    return out


def test_idle_time_goes_to_the_innermost_program_span():
    ev = _events()
    prog = program.summarize(ev)
    want = _idle_by_span_ns(ev)
    got = {k: v["idle_s"] * 1e9 for k, v in prog["spans"].items() if v["idle_s"]}
    got[None] = prog["idle_outside_s"] * 1e9
    assert got == pytest.approx(want)
    # the gap after the range read, 65-140, split as the host went: dtype
    # 65-120, up 120-121, cast 121-125, up 125-130, T1 130-140; before the
    # first kernel 0-12 lies in no program span, 12-14 in up, 14-25 in dtype
    assert (want["dtype"], want["T1"], want[None]) == (11 + 1 + 55, 10, 12 + 220)
    assert want["up"] == 2 + 1 + 5 + 5  # 695-700: the float call's last gap
    assert dict(program.gaps(prog))[None] == prog["idle_outside_s"]


def _ctx(summary):
    class Ctx:
        pass

    ctx = Ctx()
    ctx.summary = summary
    return ctx


def test_dispatch_launch_and_outside_add_up_to_the_idle_share():
    ev = _events(device_copies=True)
    summary = devtrace.summarize(program.bench_events(ev))
    prog = program.summarize(ev)
    m = program.layer_metrics(prog, summary, None, [])
    outside = 100.0 * prog["idle_outside_s"] / prog["window_s"]
    idle = manifest.reader("idle_pct.sweep")(_ctx(summary))
    assert m["idle_pct.dispatch"] + m["idle_pct.launch"] + outside == pytest.approx(idle)
    want = _idle_by_span_ns(ev)
    assert m["idle_pct.dispatch"] == pytest.approx(
        sum(want.get(k, 0) for k in program.DISPATCH) / 10)
    assert m["idle_pct.launch"] == pytest.approx(sum(want.get(k, 0) for k in program.STAGES) / 10)
    assert prog["busy_s"] == pytest.approx(summary["busy_s"])


def test_layer_metrics_per_call():
    ev = _events()
    summary = devtrace.summarize(ev)
    prog = program.summarize(ev)
    before = {"host_reads": {"acc_dtype": 10}, "launches": {"tile_pass_a": 7}}
    after = {"host_reads": {"acc_dtype": 12, "cast_checked": 0},
             "launches": {"tile_pass_a": 9, "tile_pass_c": 2, "accel_in_scan": 2,
                          "accel_near_out": 2, "accel_far_merge": 2}}
    records = [("native.tile_plan_phase1", "plan.phase1", 10, 4_000_000_010),
               ("plan.phase1", None, 0, 5_000_000_000),
               ("native.priority_flood", None, 6_000_000_000, 7_000_000_000),
               ("plan.upload", None, 8_000_000_000, 8_500_000_000),
               ("plan.down.upload", "plan.down.coarse", 9_000_000_000, 9_250_000_000),
               ("plan.down.coarse", None, 8_900_000_000, 9_300_000_000)]
    m = program.layer_metrics(prog, summary, (before, after), records)
    assert m["host_reads_per_call"] == 1.0
    assert m["launches_per_call"] == 5.0
    assert m["host_us_per_call"] == pytest.approx((386 + 298 - 77) / 2 / 1e3)
    assert m["plan_native_s"] == pytest.approx(4.0)  # the flood lies outside the plan
    assert m["plan_upload_s"] == pytest.approx(0.75)
    # the int32 call's range read (its reduction and copy) a call of both kinds
    assert m["aux_device_ms"] == pytest.approx((35 + 4) / 1e6 / 2)
    assert all(isinstance(v, float) and math.isfinite(v) for v in m.values())


def test_nothing_to_read():
    ev = _events(host_spans=False)
    summary = devtrace.summarize(ev)
    m = program.layer_metrics(program.summarize(ev), summary, None, [])
    assert set(m.values()) == {None}
    assert program.summarize([Ev("pf:up", 0, 1)]) is None
