"""Static permutations of up to 128^3 elements as one int32 gather.

The JAX package routes a static permutation through a 5-stage chain of
128-lane gathers (L-S-G-S-L), because the TPU has no fast arbitrary
gather. A Hopper card gathers directly, so the port keeps the permutation
itself: ``sigma`` as one int32 index, applied by the ``permute_gather``
kernel (H0). :meth:`RouterPlan.from_stage_tables` composes the JAX plan's
int8 stage tables into that index by replaying the chain on ``arange``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .._backend import resolve_device

__all__ = ["RouterPlan", "LaneGather", "lane_gather", "bipartite_color"]

_S = 128  # lanes per row of the (G*128, 128) layout


def _bipartite_color_py(u, v, nL, nR, deg):
    """Euler-split colouring in Python (the JAX package's fallback): the
    reference the native :func:`bipartite_color` is held to."""
    E = u.size
    levels = int(deg).bit_length() - 1
    grp = np.zeros(E, dtype=np.int64)
    for lev in range(levels):
        ngrp = 1 << lev
        nkey = (nL + nR) * ngrp
        key_u = u * ngrp + grp
        key_v = (nL + v) * ngrp + grp
        cnt = np.zeros(nkey + 1, dtype=np.int64)
        np.add.at(cnt, key_u + 1, 1)
        np.add.at(cnt, key_v + 1, 1)
        np.cumsum(cnt, out=cnt)
        cur = cnt[:-1].copy()
        inc = np.empty(2 * E, dtype=np.int64)
        for e in range(E):  # stable fill
            inc[cur[key_u[e]]] = e
            cur[key_u[e]] += 1
            inc[cur[key_v[e]]] = e
            cur[key_v[e]] += 1
        cur = cnt[:-1].copy()
        used = np.zeros(E, dtype=bool)
        for e0 in range(E):
            if used[e0]:
                continue
            g = grp[e0]
            w = u[e0]  # vertex id in [0, nL+nR): right side offset by nL
            while True:
                key = w * ngrp + g
                c = cur[key]
                while c < cnt[key + 1] and used[inc[c]]:
                    c += 1
                cur[key] = c
                if c >= cnt[key + 1]:
                    break
                e = inc[c]
                used[e] = True
                if w < nL:
                    grp[e] = grp[e] * 2
                    w = nL + v[e]
                else:
                    grp[e] = grp[e] * 2 + 1
                    w = u[e]
    return grp.astype(np.int32)


def bipartite_color(u, v, nL, nR, deg):
    """Colour a ``deg``-regular bipartite multigraph with ``deg`` colours
    (``deg`` a power of two): int32 colours in ``[0, deg)``, by the shared
    native library (:func:`pyflwdir_torch.runtime.bipartite_color`), which
    the port builds at first use."""
    from .. import runtime

    return runtime.bipartite_color(u, v, nL, nR, deg)


def _chain_np(v, G, i1, iS1, iG, iS2, i3):
    """The JAX package's 5-stage routing chain (``ops/router.py``
    ``RouterPlan._chain``) in numpy, with lane gathers by ``take_along_axis``."""

    def ta(a, idx):
        return np.take_along_axis(a, np.asarray(idx, np.int64), axis=1)

    S = _S
    v = ta(np.asarray(v).reshape(G * S, S), i1)
    v = v.reshape(G, S, S).transpose(0, 2, 1)
    v = ta(v.reshape(G * S, S), iS1)
    v = v.reshape(G, S, S).transpose(2, 1, 0)
    v = ta(v.reshape(S * S, G), iG)
    v = v.reshape(S, S, G).transpose(2, 1, 0)
    v = ta(v.reshape(G * S, S), iS2)
    v = v.reshape(G, S, S).transpose(0, 2, 1)
    return ta(v.reshape(G * S, S), i3).reshape(G * S, S)


class RouterPlan:
    """One static permutation: ``apply(x2).ravel()[p] == x2.ravel()[sigma[p]]``
    for a bijection ``sigma`` on ``[0, G*16384)``, ``G <= 128``."""

    def __init__(self, sigma, device=None):
        sigma = np.ascontiguousarray(sigma, dtype=np.int64).ravel()
        n = sigma.size
        if n == 0 or n % (_S * _S) != 0:
            raise ValueError("sigma length must be a positive multiple of 16384")
        G = n // (_S * _S)
        if G > _S:
            raise ValueError(f"router supports up to {_S * _S * _S} elements")
        seen = np.zeros(n, dtype=bool)
        in_range = (sigma >= 0) & (sigma < n)
        seen[sigma[in_range]] = True
        if not (in_range.all() and seen.all()):
            raise ValueError("sigma is not a permutation")
        self.G = G
        self.device = resolve_device(device)
        self.sigma_np = sigma
        self.sigma = torch.as_tensor(sigma.astype(np.int32), device=self.device)

    @classmethod
    def from_stage_tables(cls, G, i1, iS1, iGp, iS2, i3, device=None) -> "RouterPlan":
        """Compose a JAX 5-stage plan's int8 tables into one gather index."""
        G = int(G)
        ar = np.arange(G * _S * _S, dtype=np.int64).reshape(G * _S, _S)
        sigma = _chain_np(ar, G, i1, iS1, iGp, iS2, i3)
        return cls(sigma.ravel(), device=device)

    def apply(self, x2):
        """Permute ``x2`` ((G*128, 128) float32) — kernel H0 on the GPU."""
        return kernels.permute_gather(x2, self.sigma).reshape(x2.shape)

    def apply_np(self, x):
        """NumPy version of :meth:`apply`."""
        return np.asarray(x).ravel()[self.sigma_np].reshape(self.G * _S, _S)


class LaneGather:
    """``out[r, j] = x2[r, idx[r, j]]`` for a fixed (R, W) lane table, the
    counterpart of the JAX ``_ta``: the flat gather index ``r*W + idx[r, j]``
    is computed once here and every call launches H0."""

    def __init__(self, idx):
        idx = torch.as_tensor(idx).long()
        R, W = idx.shape
        if bool(((idx < 0) | (idx >= W)).any()):
            raise ValueError("lane indices must lie in [0, width)")
        self.shape = (R, W)
        rows = torch.arange(R, dtype=torch.int64, device=idx.device)[:, None] * W
        self.src = (rows + idx).to(torch.int32).contiguous()

    def __call__(self, x2):
        if tuple(x2.shape) != self.shape:
            raise ValueError(f"expected shape {self.shape}, got {tuple(x2.shape)}")
        return kernels.permute_gather(x2.contiguous(), self.src)


def lane_gather(x2, idx):
    """One-off lane gather ``out[r, j] = x2[r, idx[r, j]]`` (see :class:`LaneGather`)."""
    return LaneGather(torch.as_tensor(idx, device=x2.device))(x2)
