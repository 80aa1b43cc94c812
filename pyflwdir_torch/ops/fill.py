"""Device depression fill: reconstruction by erosion, and D8 from the
filled surface.

The port of the JAX package's ``ops/fill.py``. Depression filling is
**morphological reconstruction by erosion** ``w = max(dem, min_neighbors(w))``
iterated from ``w = dem`` at the outlet seeds and +inf elsewhere; its fixpoint
is exactly the priority-flood filled surface, and every value is one of the
DEM's own float32 values (only max and min are applied). One round is a down
sweep and then an up sweep of a row-sequential Gauss-Seidel update, each
sweep one launch of kernel F1 (:func:`pyflwdir_torch.kernels.fill_sweep`)
on the card or its plain PyTorch version on the CPU.

:func:`d8_from_filled` picks the steepest strictly descending neighbour and
resolves flats in rounds of shifted stencils; it is plain PyTorch, as the
JAX package leaves it to XLA.

Everything is float32. Tensors live on ``device``; ``None`` means the card.
The round counts of the last calls stand in :data:`last_rounds`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .._backend import resolve_device

__all__ = ["fill_depressions_dev", "d8_from_filled", "last_rounds"]

_INF = float("inf")

#: round counts of the last calls: ``"fill"`` sweep rounds (one down and one
#: up sweep each) of the last :func:`fill_depressions_dev`, summed over its
#: fills; ``"depth"`` its outer rounds under ``max_depth >= 0``; ``"flat"``
#: flat-resolution rounds of the last :func:`d8_from_filled`. A count equal
#: to ``max_rounds`` means the loop stopped there, converged or not, as the
#: JAX package's does.
last_rounds = {"fill": 0, "depth": 0, "flat": 0}


def _erode_from(w0, dem_eff, fixed, conn8, max_rounds):
    """Iterate sweep rounds from the upper bound ``w0`` to the fixpoint, or
    to ``max_rounds`` rounds. ``fixed`` (uint8) cells keep their value."""
    w = w0
    rounds, changed = 0, True
    while rounds < max_rounds and changed:
        down = kernels.fill_sweep(w, dem_eff, fixed, conn8, True)
        w2 = kernels.fill_sweep(down, dem_eff, fixed, conn8, False)
        changed = not torch.equal(w2, w)
        w = w2
        rounds += 1
    last_rounds["fill"] += rounds
    return w


def _pool2(x, pad_val, reduce2):
    """2x2 block-reduce (``reduce2`` the pairwise reduction), odd edges
    padded with ``pad_val``."""
    H, W = x.shape
    He, We = H + H % 2, W + W % 2
    if (He, We) != (H, W):
        xp = torch.full((He, We), pad_val, dtype=x.dtype, device=x.device)
        xp[:H, :W] = x
        x = xp
    r = reduce2(x[0::2, :], x[1::2, :])
    return reduce2(r[:, 0::2], r[:, 1::2])


def _up2(x, H, W):
    """2x nearest-neighbour upsample cropped to (H, W)."""
    return x.repeat_interleave(2, 0).repeat_interleave(2, 1)[:H, :W]


def _fill_multigrid(dem_eff, seeds, bad, conn8, max_rounds, levels):
    """Recursive coarse-to-fine erosion fill (exact): each level starts from
    ``max(dem, upsample(fill of the 2x2 max-pooled DEM))``, an upper bound of
    its fixpoint, so only the round count changes (the JAX package's
    ``_fill_multigrid`` has the argument)."""
    fixed = (seeds | bad).to(torch.uint8)
    if levels <= 0 or not conn8:
        # 4-connectivity: 2x2 block cells are not mutually adjacent, so the
        # coarse upper bound fails; solve directly
        w0 = torch.where(seeds, dem_eff, _INF)
        return _erode_from(w0, dem_eff, fixed, conn8, max_rounds)
    H, W = dem_eff.shape
    d2 = _pool2(dem_eff, _INF, torch.maximum)
    s2 = _pool2(seeds, False, torch.logical_or)
    # a seed block is a terminal at the maximum over its valid cells; other
    # blocks touching nodata stay +inf barriers
    vmax_valid = _pool2(torch.where(bad, -_INF, dem_eff), -_INF, torch.maximum)
    d2 = torch.where(s2, vmax_valid, d2)
    b2 = _pool2(bad, True, torch.logical_and) & ~s2
    wc = _fill_multigrid(d2, s2, b2, conn8, max_rounds, levels - 1)
    w0 = torch.where(seeds, dem_eff, torch.maximum(dem_eff, _up2(wc, H, W)))
    return _erode_from(w0, dem_eff, fixed, conn8, max_rounds)


def fill_setup(dem, nodata=-9999.0, outlets="edge", idxs_pit=None, connectivity=8,
               elv_max=None, device=None):
    """The fill's inputs on ``device``: ``(dem_eff, seeds, bad)``, the DEM as
    float32 with +inf at nodata, and the seed and nodata masks (bool). Seeds:
    valid edge cells (``outlets='edge'``, optionally only where ``dem <=
    elv_max``), the single lowest edge cell (``'min'``) or ``idxs_pit``."""
    from ..dem import get_edge

    device = resolve_device(device)
    dem = np.asarray(dem)
    nan = isinstance(nodata, float) and np.isnan(nodata)
    bad = np.isnan(dem) if nan else dem == nodata
    struct = np.ones((3, 3), dtype=bool)
    if connectivity == 4:
        struct[0, 0] = struct[-1, -1] = struct[0, -1] = struct[-1, 0] = False
    if idxs_pit is not None:
        seeds = np.zeros(dem.shape, bool)
        seeds.flat[np.atleast_1d(idxs_pit)] = True
    else:
        seeds = get_edge(~bad, structure=struct)
        if elv_max is not None:
            seeds = np.logical_and(seeds, dem <= elv_max)
            if not np.any(seeds):
                raise ValueError("No initial outlet cells found.")
        if outlets == "min":
            zb = np.where(seeds, dem, np.inf).astype(np.float32)
            i = np.unravel_index(np.argmin(zb), dem.shape)
            seeds = np.zeros(dem.shape, bool)
            seeds[i] = True
    dem_eff = torch.as_tensor(np.where(bad, np.inf, dem).astype(np.float32), device=device)
    return dem_eff, torch.as_tensor(seeds, device=device), torch.as_tensor(bad, device=device)


def fill_depressions_dev(
    dem,
    nodata=-9999.0,
    outlets="edge",
    idxs_pit=None,
    connectivity=8,
    max_depth=-1.0,
    elv_max=None,
    max_rounds=256,
    multigrid_min=None,
    device=None,
):
    """Depression-filled DEM (float32 tensor on ``device``, ``nodata`` at
    nodata cells), equal to the host priority flood cast to float32.

    Seeds as in :func:`fill_setup`. ``max_depth >= 0`` caps the fill depth:
    cells whose fill would reach ``max_depth`` stay at their own elevation
    and become interior pits (an outer fixpoint adds them as seeds until none
    remain; the set of such pits may differ from the heap-ordered host fill
    on depressions with several pour points). ``multigrid_min`` seeds the
    fill coarse to fine down to about that many cells a side (exact; off by
    default). A loop that reaches ``max_rounds`` stops there silently, as in
    the JAX package: :data:`last_rounds` says how many ran.
    """
    dem_eff, seeds, bad = fill_setup(dem, nodata, outlets, idxs_pit, connectivity,
                                     elv_max, device)
    conn8 = connectivity == 8
    levels = 0
    side = max(dem_eff.shape)
    while multigrid_min and side > max(int(multigrid_min), 8):
        side //= 2
        levels += 1
    last_rounds["fill"] = last_rounds["depth"] = 0

    def erode(seeds_now):
        return _fill_multigrid(dem_eff, seeds_now, bad, conn8, max_rounds, levels)

    if max_depth >= 0:
        # depth-capped fill: depth-exceeding cells stay pits, and their
        # depression drains to them instead of filling
        seeds_now, w, new_deep = seeds, dem_eff, True
        while last_rounds["depth"] < max_rounds and new_deep:
            w = erode(seeds_now)
            deep = ~seeds_now & ~bad & (w - dem_eff >= max_depth)
            seeds_now = seeds_now | deep
            new_deep = bool(deep.any())
            last_rounds["depth"] += 1
    else:
        w = erode(seeds)
    return torch.where(bad, torch.tensor(nodata, dtype=torch.float32, device=w.device), w)


# neighbour scan order of the reference loops (row-major over 3x3), codes
_DELTAS = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1) if (dr, dc) != (0, 0)]
_CODES = np.array([[32, 64, 128], [16, 0, 1], [8, 4, 2]], np.int32)


def d8_from_filled(filled, nodata=-9999.0, max_rounds=None, device=None):
    """A valid D8 raster (uint8 tensor) from a filled DEM.

    Steepest strictly descending neighbour first (distance-weighted, the
    reference's neighbour scan order on ties), then flat resolution in
    rounds: an undrained cell adopts the direction of the first
    equal-elevation neighbour that drained in an earlier round. Cells of
    flats with no outlet stay pits (0); nodata becomes 247. ``max_rounds``
    (default nrow + ncol) caps the flat rounds. ``filled`` is a tensor or an
    array; ``device`` None means the tensor's device, or the card for an
    array.
    """
    if device is None and isinstance(filled, torch.Tensor):
        device = filled.device
    device = resolve_device(device)
    z = torch.as_tensor(filled, device=device).to(torch.float32)
    nrow, ncol = z.shape
    nan = isinstance(nodata, float) and np.isnan(nodata)
    bad = torch.isnan(z) if nan else z == nodata
    zi = torch.where(bad, _INF, z)
    if max_rounds is None:
        max_rounds = nrow + ncol

    def padded(x, fill):
        p = torch.full((nrow + 2, ncol + 2), fill, dtype=x.dtype, device=device)
        p[1:-1, 1:-1] = x
        return p

    def nb(p, dr, dc):
        return p[1 + dr : 1 + dr + nrow, 1 + dc : 1 + dc + ncol]

    zp = padded(zi, _INF)
    # 1. steepest descent (strictly lower); the distance is a float32 tensor
    # on the device, so the card divides as the CPU does (a Python scalar
    # divisor becomes a reciprocal product there)
    best_slope = torch.zeros_like(zi)
    best_code = torch.zeros((nrow, ncol), dtype=torch.int32, device=device)
    for dr, dc in _DELTAS:
        dist = torch.tensor(float(np.hypot(dr, dc)), dtype=torch.float32, device=device)
        slope = (zi - nb(zp, dr, dc)) / dist
        better = slope > best_slope
        best_slope = torch.where(better, slope, best_slope)
        best_code = torch.where(better, int(_CODES[dr + 1, dc + 1]), best_code)

    # 2. flat resolution: adopt the direction toward an equal-z drained
    # neighbour; the equal-elevation masks do not change between rounds
    eq = [~bad & (nb(zp, dr, dc) == zi) for dr, dc in _DELTAS]
    code = best_code
    drained = (best_code > 0) & ~bad
    dp = padded(drained, False)
    rounds, changed = 0, True
    while rounds < max_rounds and changed:
        dp[1:-1, 1:-1] = drained
        taken = drained
        for (dr, dc), e in zip(_DELTAS, eq):
            ok = e & nb(dp, dr, dc) & ~taken
            code = torch.where(ok, int(_CODES[dr + 1, dc + 1]), code)
            taken = taken | ok
        changed = not torch.equal(taken, drained)
        drained = taken
        rounds += 1
    last_rounds["flat"] = rounds
    return torch.where(bad, 247, code).to(torch.uint8)
