"""Static permutations of up to 128 * 2^21 = 2^28 elements as one int32 gather.

The JAX package routes such a permutation through seven per-axis lane
gathers (L-S-S2-G1-S2-S-L on the ``(G1, 128, 128, 128)`` view of the flat
index), found by three rounds of edge colouring and run as five fused
Pallas passes (``ops/router_big.py`` ``_fused_pass``), because the TPU has
no fast arbitrary gather. The stage tables, the colouring and the 128 x 128
rotations are that machine's mechanism; the function is the permutation. A
Hopper card gathers directly, so the port keeps ``sigma`` itself as one
int32 index (values below 2^28) applied by the ``permute_gather`` kernel
(H0), as ``ops/router.py`` does for the 5-stage router.
:meth:`RouterPlanBig.from_stage_tables` composes a JAX plan's seven int8
tables into that index by replaying its chain on ``arange``.

At these sizes the gather does not sit in the 50 MB L2: every 4- or 8-byte
read at a scattered address fetches a 32-byte sector from device memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .._backend import resolve_device
from .router import LaneGather, _chain_np

__all__ = ["RouterPlanBig", "lane_gather_tiled", "router_sigma"]

_S = 128
_CHUNK = _S * _S * _S  # elements per g1 slice, the 5-stage router's capacity

#: the JAX ``lane_gather_tiled`` (a Pallas grid over row blocks of a lane
#: gather) is one H0 launch here: :class:`pyflwdir_torch.ops.router.LaneGather`
lane_gather_tiled = LaneGather


def _chain7_np(v, G1, st):
    """The JAX package's 7-stage routing chain (``ops/router_big.py``
    ``RouterPlanBig._chain``) in numpy: seven lane gathers by
    ``take_along_axis`` with the layout transposes between them."""

    def ta(a, idx):
        return np.take_along_axis(a, np.asarray(idx).astype(np.int64), axis=1)

    S = _S
    i1, i2, i3, i4, i5, i6, i7 = st
    Q = G1 * S
    v = ta(np.asarray(v).reshape(Q * S, S), i1)  # lanes
    v = v.reshape(Q, S, S).transpose(0, 2, 1)  # (q, l, s)
    v = ta(v.reshape(Q * S, S), i2)  # s axis
    v = v.reshape(G1, S, S, S).transpose(0, 3, 2, 1)  # (g1, sp, l, s2)
    v = ta(v.reshape(Q * S, S), i3)  # s2 axis
    v = v.reshape(G1, S, S, S).transpose(3, 1, 2, 0)  # (s2p, sp, l, g1)
    v = ta(v.reshape(S * S * S, G1), i4)  # g1 axis
    v = v.reshape(S, S, S, G1).transpose(3, 1, 2, 0)  # (g1, sp, l, s2p)
    v = ta(v.reshape(Q * S, S), i5)  # s2 axis back
    v = v.reshape(G1, S, S, S).transpose(0, 3, 2, 1)  # (g1, s2, l, sp)
    v = ta(v.reshape(Q * S, S), i6)  # s axis back
    v = v.reshape(G1, S, S, S).transpose(0, 1, 3, 2)  # (g1, s2, s, l)
    return ta(v.reshape(Q * S, S), i7)  # lanes


def router_sigma(routers, name):
    """The permutation one router of a JAX plan's table dict composes to, as
    a flat int64 index: ``routers[name]`` holds five stage tables where the
    dict is keyed ``"G"`` (``ops/router.py``), seven where it is keyed
    ``"G1"`` (``ops/router_big.py``)."""
    if "G1" in routers:
        G1 = int(routers["G1"])
        ar = np.arange(G1 * _CHUNK, dtype=np.int32)
        return _chain7_np(ar, G1, routers[name]).ravel().astype(np.int64)
    G = int(routers["G"])
    ar = np.arange(G * _S * _S, dtype=np.int64).reshape(G * _S, _S)
    return _chain_np(ar, G, *routers[name]).ravel()


class RouterPlanBig:
    """One static permutation: ``apply(x2).ravel()[p] == x2.ravel()[sigma[p]]``
    for a bijection ``sigma`` on ``[0, G1 * 2^21)``, ``G1 <= 128``."""

    def __init__(self, sigma, device=None):
        sigma = np.asarray(sigma)
        n = sigma.size
        if n == 0 or n % _CHUNK != 0:
            raise ValueError("sigma length must be a multiple of 2^21")
        G1 = n // _CHUNK
        if G1 > _S:
            raise ValueError(f"big router supports up to {_S * _CHUNK} elements")
        sigma = sigma.ravel()
        seen = np.zeros(n, dtype=bool)
        in_range = (sigma >= 0) & (sigma < n)
        seen[sigma[in_range]] = True
        if not (in_range.all() and seen.all()):
            raise ValueError("sigma is not a permutation")
        self.G1 = G1
        self.device = resolve_device(device)
        self.sigma_np = sigma.astype(np.int32)
        self.sigma = torch.as_tensor(self.sigma_np, device=self.device)

    @classmethod
    def from_stage_tables(cls, G1, i1, i2, i3, i4, i5, i6, i7, device=None) -> "RouterPlanBig":
        """Compose a JAX 7-stage plan's int8 tables into one gather index."""
        tabs = {"G1": G1, "r": (i1, i2, i3, i4, i5, i6, i7)}
        return cls(router_sigma(tabs, "r"), device=device)

    def inverse(self) -> "RouterPlanBig":
        """The plan of the inverse permutation."""
        inv = np.empty_like(self.sigma_np)
        inv[self.sigma_np] = np.arange(inv.size, dtype=np.int32)
        return RouterPlanBig(inv, device=self.device)

    def apply(self, x2):
        """Permute ``x2`` ((G1*16384, 128); float32, int32, int64 or
        float64) with kernel H0 on the GPU."""
        return kernels.permute_gather(x2.contiguous(), self.sigma).reshape(x2.shape)

    def apply_np(self, x):
        """NumPy version of :meth:`apply`."""
        return np.asarray(x).ravel()[self.sigma_np].reshape(self.G1 * _S * _S, _S)
