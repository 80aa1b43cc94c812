"""One traced run of a benchmark cell, with the program's own spans read.

Run from the repository root on a machine with an NVIDIA card:
    python3 tools/trace_cell.py --workload <cell> --seed <n> [--seconds 10]
        [--program 0|1] [--json PATH]

The cell runs as ``benchmark/run.py --trace 1`` runs it
(``benchmark.cells.run_cell``: set-up, the window under ``torch.profiler``,
the comparison with the reference), with ``pyflwdir_torch.trace.enable()``
before set-up (``--program 0`` leaves it off: the benchmark's own traced
run). The window's events are read twice: by ``devtrace.summarize``, as the
benchmark reads them (less any device-side copy of a program range,
``benchmark.program.bench_events``), and by ``benchmark.program.summarize``.
Standard error gets the device's idle time by the host's innermost program
span (``program gaps:``); the last line of standard output is the benchmark's result line
with ``program`` added: the per-layer numbers of ``benchmark.program``
(``layer_metrics``), the traced window's rate ``sweep_cells_per_s``
(Gcells/s, host clock), the dtype conversions a call made by site
(``casts_per_call``, from ``trace.casts``) and, where ``--program 1``, the
spans' summary.
``--json`` appends that line to a file.

Until ``devtrace.Tracer.window`` and ``cells.run_cell`` read the program's
spans themselves (``PERF.md`` §7), this tool puts its own tracer in
``cells.Tracer`` for the run.
"""

import argparse
import contextlib
import json
import os
import sys
import time

_T0 = time.perf_counter()

import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import cells, devtrace, manifest, program  # noqa: E402
from pyflwdir_torch import trace  # noqa: E402


class ProgramTracer(devtrace.Tracer):
    """The benchmark's tracer, which also keeps the window's program spans,
    the program's counters before and after the window and the set-up's
    records; the last one made is :attr:`last`."""

    last = None

    def __init__(self, enabled):
        super().__init__(enabled)
        ProgramTracer.last = self
        self.program = self.counters = self.setup = None
        self.window_wall_s = self.n = self.device_copies = None

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile

        self.setup = trace.records()
        trace.reset()
        c0 = trace.counters()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with self.span("window"):
                t = time.perf_counter()
                yield
                self.window_wall_s = time.perf_counter() - t
        self.counters = (c0, trace.counters())
        events = prof.profiler.kineto_results.events()
        bench = program.bench_events(events)
        self.device_copies = len(events) - len(bench)
        self.summary = devtrace.summarize(bench)
        self.program = program.summarize(events)


class _Sweeps(cells.Sweeps):
    """The benchmark's sweep cells, handing the tracer the nodes a sweep
    covers."""

    def layer_context(self, ctx):
        super().layer_context(ctx)
        self.tracer.n = ctx.n


def trace_cell(cell, seed, seconds, program_on, device, t0, overrides=None):
    """Run the sweep cell ``cell`` once, traced; returns the result line
    with ``program``."""
    saved = cells.Tracer, dict(cells.DRIVERS)
    cells.Tracer = ProgramTracer
    cells.DRIVERS.update(up=_Sweeps, down=_Sweeps)
    trace.reset()
    (trace.enable if program_on else trace.disable)()
    try:
        result, _ = cells.run_cell(manifest.load(), cell, seed, seconds, True, device, t0,
                                   overrides=overrides)
    finally:
        trace.disable()
        cells.Tracer = saved[0]
        cells.DRIVERS.update(saved[1])
    tr = ProgramTracer.last
    prog = tr.program
    out = program.layer_metrics(prog, tr.summary, tr.counters, tr.setup)
    out["sweep_cells_per_s"] = tr.n * result["attempted"] / tr.window_wall_s / 1e9
    c0, c1 = (c["casts"] for c in tr.counters)
    out["casts_per_call"] = {k: (v - c0.get(k, 0)) / result["attempted"]
                             for k, v in c1.items() if v != c0.get(k, 0)}
    out["program_spans"] = program_on
    out["device_copies"] = tr.device_copies  # program ranges mirrored on the device
    if tr.setup:
        setup = {}
        for name, _, a, b in tr.setup:
            setup[name] = setup.get(name, 0.0) + (b - a) / 1e9
        out["setup_spans"] = setup  # seconds by name, nested spans in their parents too
    if prog is not None and program_on:
        out["spans"] = prog["spans"]
        out["idle_outside_s"] = prog["idle_outside_s"]
        gaps = ", ".join(f"{k or '(outside)'} {v:.4f}" for k, v in program.gaps(prog))
        print(f"program gaps: {gaps}", file=sys.stderr, flush=True)
    result["program"] = out
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cell: no CUDA device", file=sys.stderr)
        return 3
    result = trace_cell(args.workload, args.seed, args.seconds, bool(args.program),
                        torch.device("cuda", 0), _T0)
    line = json.dumps(result)
    print(line, flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
