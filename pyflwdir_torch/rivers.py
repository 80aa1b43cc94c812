"""River classification and hydraulic depth.

The estuary classification (upstream pyflwdir ``rivers.py:11-50``) is a
path minimum on the device: a cell is estuary while the width keeps
converging on every step of its path from the sea. The gradually-varied-
flow depth (upstream ``rivers.py:53-101``) integrates each node from its
downstream node's depth, so it runs on the host in numpy, a rank level at
a time, as the JAX package does: its results are the JAX package's bits.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ._backend import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["classify_estuary", "rivdph_gvf"]


def classify_estuary(idxs_ds, idxs_pit, rivdst, rivwth, elevtn, max_elevtn=0,
                     min_convergence=1e-2, device=None):
    """Estuaries by river-width convergence (upstream pyflwdir
    ``rivers.py:11-50``): starting at the pits no higher than
    ``max_elevtn``, a cell is estuary (1) while the width converges by more
    than ``min_convergence`` on each step moving upstream; a chain cell
    whose upstream neighbour fails is the estuary's upstream end (2).

    The sequential sweep telescopes: a cell is estuary when its pit is a
    seed and the step condition holds on every cell of its path, the pit
    left out: a path minimum. On ``device`` (None: the card); returns an
    int8 tensor."""
    from .ops import graph

    dev = resolve_device(device)
    ids = torch.as_tensor(idxs_ds, device=dev)
    rivdst = torch.as_tensor(rivdst, device=dev)
    rivwth = torch.as_tensor(rivwth, device=dev)
    elevtn = torch.as_tensor(elevtn, device=dev)
    pits = torch.as_tensor(np.asarray(idxs_pit, dtype=np.int64), device=dev)
    n = ids.shape[0]
    ar = torch.arange(n, dtype=ids.dtype, device=dev)
    valid = ids >= 0
    ds = graph.self_loop(ids)
    ispit = ds == ar

    seed = torch.zeros(n, dtype=torch.bool, device=dev)
    seed[pits] = elevtn[pits] <= max_elevtn
    dx = rivdst - rivdst[ds]
    if not dx.dtype.is_floating_point:  # the JAX package's int / weak float
        dx = dx.to(torch.float64)
    dw = rivwth[ds] - rivwth
    fwd = dx > 0
    conv = dw / torch.where(fwd, dx, torch.ones_like(dx))
    conv = torch.where(fwd, conv, torch.zeros_like(conv))
    cond = ((rivdst[ds] == 0) & (dw <= 0)) | (fwd & (conv > min_convergence))
    cond = cond & valid & ~ispit

    root = graph.reach(ids, None)
    pathmin = graph.path_reduce(ids, cond.to(torch.int32), op="min")
    chain = torch.where(ispit, seed, (pathmin > 0) & seed[root] & valid)
    # the upstream end: a chain cell with an upstream neighbour that fails
    fail = valid & ~ispit & ~cond & chain[ds]
    below = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    below.index_add_(0, torch.where(fail, ds, torch.full_like(ds, n)),
                     torch.ones(n, dtype=torch.int32, device=dev))
    est = chain.to(torch.int8)
    return torch.where(chain & (below[:n] > 0), torch.full_like(est, 2), est)


def _gvf_depth_gradient(h, w, q, nman, s0, eps, g=9.81):
    """Gradually-varied-flow depth gradient of a rectangular channel,
    vectorised over nodes: the friction slope from Manning's equation with
    hydraulic radius ``wh / (w + 2h)``, over one less the squared Froude
    number (the physics of upstream ``rivers.py:63-70``)."""
    h = np.maximum(h, eps)
    area = w * h
    rad = area / (w + 2.0 * h)
    sf = (nman * q / area) ** 2 * rad ** (-4.0 / 3.0)
    fr2 = (q / (w * np.sqrt(g * h))) ** 2
    return (s0 - sf) / (1.0 - fr2)


def rivdph_gvf(idxs_ds, rank, zs, rivdph, qbankfull, rivdst, rivwth, manning,
               min_rivslp=1e-5, min_rivdph=1, eps=1e-1, n_iter=2, n_substeps=16):
    """Gradually-varied-flow river depth (host, experimental; upstream
    pyflwdir ``rivers.py:53-101``). Each node's depth is its downstream
    node's depth integrated upstream over the reach, so the nodes of one
    rank are independent: the solver sweeps the rank levels and integrates
    a level at once by fixed-step RK4 (``n_substeps`` steps a reach).
    Updates with |dh/dx| > 1, a negative or a non-finite depth are
    rejected; ``n_iter`` passes, the bed levels updated between them.
    Numpy float64 throughout, as the JAX package."""
    ranks = np.asarray(rank).ravel()
    ds = np.asarray(idxs_ds).ravel()
    q = np.asarray(qbankfull, dtype=np.float64)
    w = np.asarray(rivwth, dtype=np.float64)
    x = np.asarray(rivdst, dtype=np.float64)
    nman = np.asarray(manning, dtype=np.float64)
    depth = np.asarray(rivdph, dtype=np.float64).copy()

    live = (ranks >= 1) & (q > 0) & (w > 0) & (ds != np.arange(ds.size))
    max_rank = int(ranks.max()) if ranks.size else 0
    for _ in range(n_iter):
        zbed = np.asarray(zs, dtype=np.float64) - depth
        for r in range(1, max_rank + 1):
            lvl = np.where(live & (ranks == r))[0]
            if lvl.size == 0:
                continue
            dn = ds[lvl]
            dx = x[lvl] - x[dn]
            slp = np.maximum(min_rivslp, (zbed[lvl] - zbed[dn]) / dx)
            h = depth[dn].copy()
            step = dx / n_substeps
            for _k in range(n_substeps):
                # classic RK4 on dh/ds = +gradient, integrating upstream
                k1 = _gvf_depth_gradient(h, w[lvl], q[lvl], nman[lvl], slp, eps)
                k2 = _gvf_depth_gradient(h + 0.5 * step * k1, w[lvl], q[lvl], nman[lvl], slp,
                                         eps)
                k3 = _gvf_depth_gradient(h + 0.5 * step * k2, w[lvl], q[lvl], nman[lvl], slp,
                                         eps)
                k4 = _gvf_depth_gradient(h + step * k3, w[lvl], q[lvl], nman[lvl], slp, eps)
                h = h + step / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            bad = (np.abs((h - depth[dn]) / dx) > 1) | (h < 0) | ~np.isfinite(h)
            if bad.any():
                logger.warning("gvf: rejecting %d unstable depth updates", int(bad.sum()))
            upd = lvl[~bad]
            depth[upd] = np.maximum(min_rivdph, h[~bad])
    return depth
