"""Seeded inputs of the benchmark, made on the device in a few large calls.

Everything here is plain PyTorch and imports nothing of the program under
test. The same seed on the same kind of device gives the same inputs.

* :func:`scheidegger_d8`: a D8 raster after Scheidegger's river-network model
  (Scheidegger 1967, "A stochastic model for drainage patterns into an
  intramontane trench", Bull. IASH 12(1)): a plane falls toward the lower and
  right edges, and every cell drains to one of its neighbours that lie
  strictly lower on that plane (east, south-east, south), chosen by seeded
  noise. Paths only move down or right, so there are no cycles; a cell whose
  choice leaves the grid is an outlet, so pits lie only on the lower and
  right edges; rivers merge into basins whose areas are heavy-tailed.
* :func:`contract_reaches`: the confluence-to-confluence reaches of such a
  network, as HydroRIVERS breaks its rivers, by pointer doubling; reach ids
  keep the raster order of each reach's first cell.
* :func:`relief_dem`: multi-octave value noise on a tilt, in metres (float32):
  one fixed landscape, which no seed draws.
* :func:`make_field`: the per-cell inputs of a traffic mix.
"""

from __future__ import annotations

import math

import torch

# D8 codes of the pyflwdir convention, by (dr, dc)
D8_CODE = {(0, 1): 1, (1, 1): 2, (1, 0): 4, (1, -1): 8, (0, -1): 16,
           (-1, -1): 32, (-1, 0): 64, (-1, 1): 128}
_NAMED = {"E": (0, 1), "SE": (1, 1), "S": (1, 0)}


def device_generator(device, seed, stream=0):
    """A ``torch.Generator`` on ``device`` for ``seed`` (any whole number
    below 2**63), one independent stream per ``stream``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(stream)) % (1 << 63))
    return g


def scheidegger_d8(shape, choices, seed, device, stream=0):
    """``(codes, ds)``: the D8 raster (uint8, ``shape``) and each cell's
    downstream cell in raster order (int64, ``ds[i] == i`` at an outlet).

    Every cell draws one of ``choices`` (names in ``"E"``, ``"SE"``,
    ``"S"``) with equal odds; a draw that leaves the grid keeps its code and
    makes the cell an outlet, as a river leaving a tile does."""
    H, W = (int(v) for v in shape)
    deltas = [_NAMED[c] for c in choices]
    g = device_generator(device, seed, stream)
    pick = torch.randint(0, len(deltas), (H, W), generator=g, device=device)
    dr = torch.tensor([d[0] for d in deltas], device=device)[pick]
    dc = torch.tensor([d[1] for d in deltas], device=device)[pick]
    codes = torch.tensor([D8_CODE[d] for d in deltas], dtype=torch.uint8, device=device)[pick]
    r = torch.arange(H, device=device).view(H, 1)
    c = torch.arange(W, device=device).view(1, W)
    rr, cc = r + dr, c + dc
    inside = (rr < H) & (cc < W)
    own = r * W + c
    ds = torch.where(inside, rr * W + cc, own).reshape(-1)
    return codes, ds


def indegree(ds):
    """Number of upstream neighbours of every node (pits do not count as
    their own)."""
    n = ds.numel()
    moving = ds != torch.arange(n, device=ds.device)
    return torch.bincount(ds[moving], minlength=n)


def contract_reaches(ds):
    """``(reach_ds, heads)``: the reach network of the cell network ``ds``.

    A reach starts at every cell whose in-degree is not 1 (a headwater, or a
    confluence) and runs down to the cell above the next such start. The
    reaches are numbered in the raster order of their first cells (``heads``,
    int64 cell ids); ``reach_ds[k]`` is the reach that reach ``k`` flows into,
    or ``k`` itself at an outlet (its last cell is an outlet cell)."""
    n = ds.numel()
    ar = torch.arange(n, device=ds.device)
    pit = ds == ar
    head = indegree(ds) != 1
    # nearest start at or below each cell, by pointer doubling: a start or an
    # outlet points at itself, every other cell at its downstream cell
    nxt = torch.where(head | pit, ar, ds)
    while True:
        nxt2 = nxt[nxt]
        if torch.equal(nxt2, nxt):
            break
        nxt = nxt2
    heads = torch.nonzero(head).reshape(-1)
    below = nxt[ds[heads]]
    # a head that is an outlet, or whose run ends at an outlet that starts no
    # reach of its own, is an outlet reach
    outlet = pit[heads] | ~head[below]
    rank = torch.cumsum(head.to(torch.int64), 0) - 1
    k = torch.arange(heads.numel(), device=ds.device)
    reach_ds = torch.where(outlet, k, rank[below])
    return reach_ds, heads


def relief_dem(shape, dem_cfg, device):
    """Multi-octave value noise on a tilt, in metres (float32, ``shape``).

    ``dem_cfg``: ``base_m`` (elevation of the upper left corner),
    ``tilt_m_per_cell`` (fall per row, per column), ``octaves_cells`` (the
    wavelengths in cells), ``amp_m_at`` ([wavelength, amplitude in metres]) and
    ``hurst`` (amplitude grows as wavelength ** hurst). Each octave is a grid
    of uniform values in [-1, 1] at its wavelength, upsampled bilinearly, from
    a generator of its own keyed by its wavelength alone: so adding or removing
    an octave changes no other, and a tile is one landscape, whatever the
    run's seed."""
    H, W = (int(v) for v in shape)
    ref_len, ref_amp = dem_cfg["amp_m_at"]
    r = torch.arange(H, device=device, dtype=torch.float32).view(H, 1)
    c = torch.arange(W, device=device, dtype=torch.float32).view(1, W)
    tr, tc = dem_cfg["tilt_m_per_cell"]
    z = float(dem_cfg["base_m"]) - tr * r - tc * c
    for lam in dem_cfg["octaves_cells"]:
        g = device_generator(device, 0, 3000 + lam)
        amp = ref_amp * (lam / ref_len) ** dem_cfg["hurst"]
        h, w = math.ceil(H / lam) + 1, math.ceil(W / lam) + 1
        coarse = torch.rand((1, 1, h, w), generator=g, device=device) * 2 - 1
        up = torch.nn.functional.interpolate(
            coarse, size=((h - 1) * lam, (w - 1) * lam), mode="bilinear",
            align_corners=False)
        z = z + amp * up[0, 0, :H, :W]
    return z.to(torch.float32).contiguous()


def step_lengths_m(shape, ds, geo):
    """Length in metres of each cell's step to its downstream cell (float32,
    0 at outlets), on a regular latitude-longitude grid of ``geo``
    (``cellsize_deg``, ``north``): a spherical earth of radius 6,371,007 m."""
    H, W = (int(v) for v in shape)
    dev = ds.device
    ar = torch.arange(H * W, device=dev)
    dr = (ds // W - ar // W).to(torch.float64)
    dc = (ds % W - ar % W).to(torch.float64)
    cs = math.radians(float(geo["cellsize_deg"]))
    lat = math.radians(float(geo["north"])) - (ar // W + 0.5).to(torch.float64) * cs
    dy = 6371007.0 * cs
    dx = dy * torch.cos(lat)
    return torch.sqrt((dr * dy) ** 2 + (dc * dx) ** 2).to(torch.float32)


def make_field(spec, n, seed, stream, device, ds=None, shape=None, geo=None):
    """One input field of ``n`` values (1-D, on ``device``) from its traffic
    ``spec``: ``fill`` is ``ones``; ``mask`` (0/1 with odds ``p``);
    ``lognormal`` (``mu``, ``sigma``: positive runoff or areas); ``step`` (1
    where a cell moves downstream, 0 at outlets); ``step_m`` (the step's
    length in metres, from ``geo``). ``dtype`` names the torch dtype."""
    dtype = getattr(torch, spec["dtype"])
    fill = spec["fill"]
    g = device_generator(device, seed, 1000 + stream)
    if fill == "ones":
        x = torch.ones(n, device=device)
    elif fill == "mask":
        x = (torch.rand(n, generator=g, device=device) < float(spec["p"])).to(torch.float32)
    elif fill == "lognormal":
        x = torch.empty(n, dtype=torch.float64, device=device)
        x.log_normal_(float(spec["mu"]), float(spec["sigma"]), generator=g)
    elif fill == "step":
        x = ds != torch.arange(n, device=device)
    elif fill == "step_m":
        x = step_lengths_m(shape, ds, geo)
    else:
        raise ValueError(f"unknown fill {fill!r}")
    return x.to(dtype).contiguous()
