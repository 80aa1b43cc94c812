"""The plain reference, and the comparisons that decide ``correct``.

Plain PyTorch, on whatever device its inputs live; it imports nothing of the
program under test and reads only the benchmark's own inputs (the graph the
generator made, the fields, the DEMs) and the program's outputs it judges.

* Upward accumulation (every node gets the sum over itself and all nodes
  upstream) and the downward path sum (every node gets the sum over itself
  and every node below it to its outlet) run level by level over the depth
  of each node, which pointer doubling finds: one ``index_add_`` (or one
  gather) a level. The sums run in int64 for integer fields and in float64
  (or the precision asked for: the control) for float fields.
* A D8 raster from a DEM is judged by a certificate: ``G``, the highest
  elevation on each cell's path to its outlet, is the depression-filled
  surface exactly when every path ends at an edge outlet, ``G`` equals the
  DEM at the edge, and no cell could reach a lower ``G`` through a neighbour
  (``G[i] <= max(z[i], min G[nb])``). On that surface every drained cell
  must take a steepest strictly lower neighbour, and only edge cells may be
  outlets; a cell with no lower neighbour then steps to an equal one (a
  flat), since ``G`` never rises downstream.
"""

from __future__ import annotations

import math

import torch


def depths(ds):
    """Steps from every node to its outlet (int64), by pointer doubling
    over ``ds`` (``ds[i] == i`` at an outlet). Raises on a cycle."""
    n = ds.numel()
    ar = torch.arange(n, device=ds.device)
    d = (ds != ar).to(torch.int64)
    p = ds.clone()
    for _ in range(max(1, n.bit_length()) + 1):
        d = d + d[p]
        p2 = p[p]
        if torch.equal(p2, p):
            break
        p = p2
    if not torch.equal(ds[p], p):  # a cycle: doubling ends on it, not on an outlet
        raise ValueError("the graph has a cycle")
    return d


class Levels:
    """The nodes of ``ds`` grouped by depth: ``order`` (node ids by depth)
    and ``bounds`` (host list; level ``k`` is ``order[bounds[k]:bounds[k+1]]``)."""

    def __init__(self, ds):
        self.ds = ds
        d = depths(ds)
        self.order = torch.argsort(d, stable=True)
        counts = torch.bincount(d)
        self.bounds = [0] + torch.cumsum(counts, 0).tolist()

    def level(self, k):
        return self.order[self.bounds[k]:self.bounds[k + 1]]

    @property
    def n_levels(self):
        return len(self.bounds) - 1

    def up(self, x):
        """Upward accumulation of ``x`` ((n,) or (n, k)) in ``x``'s dtype."""
        acc = x.clone()
        for k in range(self.n_levels - 1, 0, -1):
            idx = self.level(k)
            acc.index_add_(0, self.ds[idx], acc[idx])
        return acc

    def down(self, x):
        """Inclusive downstream path sum of ``x`` ((n,) or (n, k))."""
        acc = x.clone()
        for k in range(1, self.n_levels):
            idx = self.level(k)
            acc[idx] = x[idx] + acc[self.ds[idx]]
        return acc


def sum_dtype(dtype, control=False):
    """The precision the reference sums a field of ``dtype`` in: int64 for
    integers, float64 for floats; the control one step below, float32."""
    if not dtype.is_floating_point:
        return torch.int64
    return torch.float32 if control else torch.float64


def reference_sweeps(levels, op, fields, control=False):
    """The reference result of each distinct field (a dict keyed by the
    field's index), summed in :func:`sum_dtype`; fields of one dtype share
    one level pass."""
    out = {}
    groups = {}
    for i, x in enumerate(fields):
        groups.setdefault(x.dtype, []).append(i)
    for dtype, idx in groups.items():
        stack = torch.stack([fields[i].to(sum_dtype(dtype, control)) for i in idx], 1)
        res = levels.up(stack) if op == "up" else levels.down(stack)
        for j, i in enumerate(idx):
            out[i] = res[:, j].contiguous()
        del stack, res
    return out


def compare_sweeps(op, outputs, field_of, refs, fields):
    """The numbers compared for a sweep cell:

    * ``int_cells_off``: output cells of integer fields that differ from
      the reference, summed over the step's sweeps;
    * upward, ``float_gap_of_total``: the largest ``|out - ref|`` over the
      float fields' outputs, each over its field's total ``sum |x|`` (an
      upward sum taken in another order is off by a few ulps of the sums
      it passes through, which reach the total, whatever the cell's own sum);
    * downward, ``float_rel_gap``: the largest ``|out - ref| / max(|ref|,
      1)`` (a path sum returned in float32 is off by its last rounding).
    """
    nums = {}
    off = 0
    gap = 0.0
    has_int = has_float = False
    for out, fi in zip(outputs, field_of):
        ref = refs[fi]
        if out is None:  # a sweep the step never returned: every cell is off
            out = torch.full_like(ref, -1)
        if fields[fi].dtype.is_floating_point:
            has_float = True
            r = ref.to(torch.float64)
            d = (out.to(torch.float64) - r).abs()
            if op == "up":
                g = d.max() / fields[fi].to(torch.float64).abs().sum()
            else:
                g = (d / r.abs().clamp_min(1.0)).max()
            gap = max(gap, float(g))
        else:
            has_int = True
            off += int((out.to(torch.int64) != ref).sum())
    if has_int:
        nums["int_cells_off"] = off
    if has_float:
        nums["float_gap_of_total" if op == "up" else "float_rel_gap"] = gap
    return nums


# ---------------------------------------------------------------------------
# D8 from a DEM
# ---------------------------------------------------------------------------
_DELTAS = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1) if (dr, dc) != (0, 0)]


def _shifted(x, dr, dc, fill):
    """``x[r + dr, c + dc]`` for every cell, ``fill`` outside the grid."""
    H, W = x.shape
    p = torch.full((H + 2, W + 2), fill, dtype=x.dtype, device=x.device)
    p[1:-1, 1:-1] = x
    return p[1 + dr:1 + dr + H, 1 + dc:1 + dc + W]


def judge_d8(z, ds):
    """Judge the graph ``ds`` (int64 raster-order downstream ids, from the
    program's raster) against the DEM ``z`` (float32, the benchmark's own)
    with the certificate of the module docstring. Returns the counts of
    cells that break each rule; their sum is the number compared."""
    H, W = z.shape
    n = H * W
    dev = z.device
    ar = torch.arange(n, device=dev)
    r, c = ar // W, ar % W
    counts = {}
    in_range = (ds >= 0) & (ds < n)
    counts["bad_index"] = int((~in_range).sum())
    ds = torch.where(in_range, ds, ar)
    near = ((ds // W - r).abs() <= 1) & ((ds % W - c).abs() <= 1)
    counts["not_a_neighbour"] = int((~near).sum())
    ds = torch.where(near, ds, ar)
    pit = ds == ar
    zf = z.reshape(-1)
    edge = (r == 0) | (r == H - 1) | (c == 0) | (c == W - 1)

    # G: highest elevation on the path to the outlet, by pointer doubling
    g = zf.clone()
    p = ds.clone()
    for _ in range(n.bit_length() + 1):
        g = torch.maximum(g, g[p])
        p2 = p[p]
        if torch.equal(p2, p):
            break
        p = p2
    ends = ds[p] == p  # the path ends at an outlet, not on a cycle
    counts["cycle"] = int((~ends).sum())
    counts["outlet_inland"] = int((ends & ~edge[p]).sum())

    g2 = g.reshape(H, W)
    lowest = torch.full_like(g2, math.inf)
    for dr, dc in _DELTAS:
        lowest = torch.minimum(lowest, _shifted(g2, dr, dc, math.inf))
    lowest = lowest.reshape(-1)
    fixed = torch.where(edge, g == zf, g <= torch.maximum(zf, lowest))
    counts["not_filled_surface"] = int((~fixed).sum())

    # the steepest strictly lower neighbour on G
    best = torch.zeros(n, dtype=torch.float32, device=dev)
    taken = torch.full((n,), -math.inf, dtype=torch.float32, device=dev)
    for dr, dc in _DELTAS:
        dist = torch.tensor(math.hypot(dr, dc), dtype=torch.float32, device=dev)
        s = ((g2 - _shifted(g2, dr, dc, math.inf)) / dist).reshape(-1)
        best = torch.maximum(best, s)
        to_it = ds == ar + dr * W + dc
        taken = torch.where(to_it & ~pit, s, taken)
    drains = best > 0
    tol = best * (1 - 2.0 ** -20)
    counts["not_steepest"] = int((~pit & drains & (taken < tol)).sum())
    counts["pit_drains"] = int((pit & drains).sum())
    counts["pit_inland"] = int((pit & ~edge).sum())
    return counts
