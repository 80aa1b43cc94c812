"""Tile plans on disk: build once, load in a later process without a rebuild.

A saved plan is a directory: a ``plan.json`` manifest beside one ``.npy``
file per array. Two formats load:

* **the JAX package's** (``pyflwdir_tpu/ops/plan_io.py``: ``"format"`` 1,
  ``"kind"`` ``"tile_plan"``), of any tile height: the stage tables (with
  the group stage ``*_ig`` of tiles taller than 128 rows) under ``tabs/``, the coarse
  DFS plan, slot maps and router stages under ``coarse/``, and the downward
  tables under ``down/``, ``cd/`` and ``coarse_down/``. They are read with
  numpy and replayed into the port's indices by
  :meth:`TilePlan.from_stage_tables` (every chain over every slot: seconds at
  36 M cells); the manifest's keys are the JAX writer's.
* **the port's own** (``"kind"`` ``"tile_plan_torch"``), which
  :func:`save_tile_plan` writes: the composed int32 indices under ``idx/``
  and ``down_idx/``, the coarse DFS plan and slot maps under ``coarse/`` and
  the coarse level's composed down indices under ``coarse_down/``. A plan the
  port builds has no stage tables, so this is the one format it writes.
  Its manifest keeps the tile height (``"tile_rows"``).

Loading runs no phase 1, no sort phase and no tile-plan build; the port's
format rebuilds only the coarse level's indices from its DFS plan. With
``mmap=True`` the per-tile arrays stay memory-mapped: a banded sweep
(:meth:`TilePlan.accumulate_banded`) reads each band's slices from disk,
and the first monolithic call uploads them whole.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["PLAN_FORMAT", "KIND", "save_tile_plan", "load_tile_plan"]

PLAN_FORMAT = 1
KIND = "tile_plan_torch"
_JAX_KIND = "tile_plan"  # the JAX package's writer
_CD_KEYS = ("pre", "pos", "ends_pre", "e2n", "wmap")
_COARSE_DFS = ("preorder", "pos", "size")


def _save(root, group, name, arr):
    d = os.path.join(root, group)
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, f"{name}.npy"), np.ascontiguousarray(arr))


def _load(root, group, name, mmap=False):
    # copy-on-write maps: pages are read at first use, and the arrays are
    # writable, as torch.as_tensor wants them
    return np.load(os.path.join(root, group, f"{name}.npy"), mmap_mode="c" if mmap else None)


def _cfg(meta):
    return {k: meta[k] for k in ("shape", "tile_rows", "far_mode", "b", "R_pad", "E_pad",
                                 "F_rows", "has_far", "has_entries")}


def _coarse_meta(path, meta):
    return {"in_slot": _load(path, "coarse", "in_slot"),
            "out_slot": _load(path, "coarse", "out_slot"),
            "m": int(meta["coarse_m"]), "D": int(meta["coarse_D"])}


def save_tile_plan(tp, path, down=True):
    """Write a :class:`~pyflwdir_torch.ops.tile_plan.TilePlan` to the
    directory ``path`` in the port's format; returns the manifest. With
    ``down=True`` the downward indices are built (if they are not yet) and
    written too, so the loaded plan serves :meth:`accumulate_down` as well;
    a plan loaded without them is written without them."""
    down = bool(down) and (tp.down_idx is not None or tp._down_src is not None)
    if down:
        tp._ensure_down()
    os.makedirs(path, exist_ok=True)
    meta = {
        "format": PLAN_FORMAT,
        "kind": KIND,
        "shape": list(tp.shape),
        "tile_rows": int(tp.Y),
        "far_mode": tp.far_mode,
        "b": int(tp.b),
        "R_pad": int(tp.R_pad),
        "E_pad": int(tp.E_pad),
        "F_rows": int(tp.F_rows),
        "has_far": bool(tp.has_far),
        "has_entries": bool(tp.has_entries),
        "n_exit_flat": int(tp.n_exit_flat),
        "coarse_kind": type(tp.coarse).__name__,
        "coarse_m": int(tp._coarse_meta["m"]),
        "coarse_D": int(tp._coarse_meta["D"]),
        "down": down,
        "idx": sorted(tp.idx),
    }
    for k, v in tp.idx.items():
        _save(path, "idx", k, v)
    dfs = tp.coarse.dfs
    for k, v in zip(_COARSE_DFS, (dfs.preorder_np, dfs.pos_np, dfs.size_np)):
        _save(path, "coarse", k, v)
    for k in ("in_slot", "out_slot"):
        _save(path, "coarse", k, tp._coarse_meta[k])
    if down:
        meta["down_idx"] = sorted(tp.down_idx)
        meta["coarse_down"] = sorted(tp.coarse.down)
        for k, v in tp.down_idx.items():
            _save(path, "down_idx", k, v)
        for k, v in tp.coarse.down.items():
            _save(path, "coarse_down", k, v)
    # the manifest last: a directory cut short does not load
    with open(os.path.join(path, "plan.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def _load_port(path, meta, mmap, device):
    from .tile_plan import TilePlan

    idx = {k: _load(path, "idx", k, mmap) for k in meta["idx"]}
    down_idx = coarse_down = None
    if meta["down"]:
        down_idx = {k: _load(path, "down_idx", k, mmap) for k in meta["down_idx"]}
        coarse_down = {k: _load(path, "coarse_down", k) for k in meta["coarse_down"]}
    return TilePlan.from_indices(
        _cfg(meta), idx, _coarse_meta(path, meta),
        tuple(_load(path, "coarse", k) for k in _COARSE_DFS), meta["coarse_kind"],
        down_idx=down_idx, coarse_down=coarse_down, device=device)


def _stages(path, group, name, n):
    return tuple(np.asarray(_load(path, group, f"{name}_{i}")) for i in range(n))


def _load_jax(path, meta, mmap, device):
    from .tile_plan import TilePlan

    kind = meta["coarse_kind"]
    # the coarse level's router stages: 5 per router of the single-chunk
    # plan (keyed "G"), 7 of the chunked one ("G1")
    key, n_st = {"_CoarseRouterSmall": ("G", 5), "BigAccelPlan": ("G1", 7)}.get(kind, (None, 0))
    routers = None
    if key is not None:
        routers = {key: np.int64(meta[f"coarse_{key}"])}
        for name in meta["coarse_routers"]:
            routers[name] = _stages(path, "coarse", name, n_st)
    down = None
    if meta.get("down"):
        down = {"tabs": {k: _load(path, "down", k, mmap) for k in meta["down_tabs"]},
                "cd": {k: _load(path, "cd", k) for k in _CD_KEYS}, "routers": None}
        if meta.get("down_coarse_router"):
            down["routers"] = {key: np.int64(meta[f"coarse_{key}"])}
            for name in ("r_es", "r_dea", "r_deb"):
                down["routers"][name] = _stages(path, "coarse_down", name,
                                                int(meta.get("down_coarse_stages", 5)))
    tabs = {k: _load(path, "tabs", k, mmap) for k in meta["tabs"]}
    return TilePlan.from_stage_tables(
        tabs, _cfg(meta), _coarse_meta(path, meta),
        tuple(_load(path, "coarse", k) for k in _COARSE_DFS),
        routers=routers, down=down, device=device)


def load_tile_plan(path, mmap=True, device=None):
    """Load a saved tile plan, of the port's format or the JAX package's
    (``PLAN_FORMAT`` 1), onto ``device`` (None: the card), at the tile height
    it was saved with (``tile_rows`` 128, 256, 384 or 512; another raises
    ValueError). A directory that holds neither format raises ValueError;
    a plan saved without its downward tables loads, and its
    ``accumulate_down`` raises RuntimeError."""
    with open(os.path.join(path, "plan.json")) as f:
        meta = json.load(f)
    load = {KIND: _load_port, _JAX_KIND: _load_jax}.get(meta.get("kind"))
    if load is None or meta.get("format") != PLAN_FORMAT:
        raise ValueError(f"{path}: not a tile-plan directory")
    return load(path, meta, mmap, device)
