"""Timing-only copies of the port whose cluster tile kernels (tiles of 256-512
rows) leave out one cost, for ``bench_torch_tiles.py`` to time beside the
real kernels. Their results are wrong by design: never use them for anything
but a time.

    python3 tools/tile_ablations.py OUT_DIR [--root DIR]

Copies ``pyflwdir_torch`` and ``csrc`` (the host library) of the checkout
``--root`` (default: this one) into ``OUT_DIR/<variant>/`` for each variant,
with ``csrc/tile_kernels.cu`` patched where the cluster kernels' gathers
and barriers go, then prints the variant directories:

* ``local``: ``tile_elem`` reads every element from the reading CTA's own
  chunk (``i mod 16,384``), so no gather leaves the CTA: the time of the same
  kernel without distributed-shared-memory gathers;
* ``nobarrier``: T2's and T3's cluster barriers between their phases are
  CTA barriers (``__syncthreads``); the last before a CTA leaves stays (a
  peer may still read its shared memory): the time without the cluster
  barriers between the phases.

The 128-row kernels (G = 1) do not change. Run, for example, on the card:

    python3 tools/tile_ablations.py _abl
    python3 bench_torch_tiles.py . _abl/local _abl/nobarrier . --rows 256,384,512
"""

import argparse
import os
import re
import shutil
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the body of the cluster branch of tile_elem, and the kernels whose cluster
# barriers "nobarrier" counts out (T4 lite indexes by values peers stage, so
# its barriers stay)
_BARRIER_FREE = ("tile_pass_c_kernel", "tile_down_a_kernel")
_RULE = "// " + "-" * 75
_ELEM = re.compile(r"(T& tile_elem\(T\* buf, int i\) \{.*?\} else \{\n)(.*?)(\n  \}\n\})", re.S)


def patch(text, variant):
    """``tile_kernels.cu``'s text with ``variant``'s change; raises where
    the code it patches is not found."""
    if variant == "local":
        text, n = _ELEM.subn(r"\1    return buf[i & (kSlots - 1)];\3", text)
        if n != 1:
            raise ValueError("tile_elem not found")
    elif variant == "nobarrier":
        parts = text.split(_RULE)
        n = 0
        for k, part in enumerate(parts):
            if any(f"{name}(const T* __restrict__ x" in part for name in _BARRIER_FREE):
                lines = part.split("\n")
                for i, line in enumerate(lines):
                    if "tile_sync();" in line and "peers may still read" not in line:
                        lines[i] = line.replace("tile_sync();", "__syncthreads();")
                        n += 1
                parts[k] = "\n".join(lines)
        if n == 0:
            raise ValueError("no cluster barrier of T2 or T3 found")
        text = _RULE.join(parts)
    else:
        raise ValueError(f"unknown variant {variant}")
    return text


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="directory of the variant checkouts")
    ap.add_argument("--root", default=_HERE, help="checkout whose port is copied")
    ap.add_argument("--variants", default="local,nobarrier")
    args = ap.parse_args()
    src = os.path.join(args.root, "pyflwdir_torch")
    with open(os.path.join(src, "csrc", "tile_kernels.cu")) as f:
        text = f.read()
    for v in args.variants.split(","):
        dst = os.path.join(args.out, v)
        shutil.rmtree(dst, ignore_errors=True)
        for sub in ("pyflwdir_torch", "csrc"):
            shutil.copytree(os.path.join(args.root, sub), os.path.join(dst, sub),
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
        with open(os.path.join(dst, "pyflwdir_torch", "csrc", "tile_kernels.cu"), "w") as f:
            f.write(patch(text, v))
        print(os.path.abspath(dst))
    return 0


if __name__ == "__main__":
    sys.exit(main())
