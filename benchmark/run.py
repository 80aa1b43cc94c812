"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``pyflwdir_torch``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit;
the same checks are the last lines of standard error. Without a CUDA device
(or with fewer than the cell asks for), or with JAX or the JAX package loaded
once the window has closed, it exits with another code than 0 and prints no
result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# import the benchmark as a package from the checkout's root, never its
# modules by their bare names (one would shadow the standard library's)
sys.path[0] = _ROOT

#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "pyflwdir_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cells, manifest

    bench = manifest.load(_ROOT)
    wl = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"no result: the cell needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result, checks = cells.run_cell(bench, args.workload, args.seed, args.seconds,
                                    bool(args.trace), device, _T0)
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules {bad} are loaded", file=sys.stderr)
        return 4
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
