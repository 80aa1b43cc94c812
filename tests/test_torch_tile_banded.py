"""The port's banded sweep, ``TilePlan.accumulate_banded``, against the JAX
package's, on the CPU (the kernels' plain versions; the JAX plan through its
vmap path, ``_pass_a_tiles`` and ``_pass_c_tiles`` off the TPU, each band's
pass compiled by ``jax.jit``).

Integers bitwise equal to the JAX banded sweep and to the port's monolithic
``accumulate``, for one, two and all tile rows a band, with and without
``out_cb``; float64 within rtol 1e-12 plus 2 * n * eps * total of the JAX
float64 DFS plan (the port sums in another order; its unfused passes take
the fused ones' order, so they equal the port's ``accumulate`` bitwise). The
unfused passes alone (kernel rows 7 and 8, T1 exits only and T2 in full
mode) against the JAX functions on one band. Grids: 300x260 (ragged tiles,
missing cells, the gather coarse level) and 256x256 with the coarse
thresholds lowered in both packages (the single-chunk router and the
``BigAccelPlan`` coarse levels).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyflwdir_torch import kernels
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu.ops import plan as jplan
from pyflwdir_tpu.ops import tile_plan as jtpm
from tests.test_torch_tile_plan import _demo_d8, _jit_banded, _Thresholds

_EPS = np.finfo(np.float64).eps

# name: (grid, _COARSE_ROUTER_MIN, _COARSE_SMALL_MAX, coarse level)
_GRIDS = {
    "300x260": (lambda: _demo_d8((300, 260), 59), None, None, "_CoarseGather"),
    "256x256-router": (lambda: _demo_d8((256, 256), 8), 1, None, "_CoarseRouterSmall"),
    "256x256-big": (lambda: _demo_d8((256, 256), 8), 1, 0, "BigAccelPlan"),
}


def _plans(request):
    make, router_min, small_max, coarse_kind = _GRIDS[request.param]
    d8 = make()
    ids = td8.from_array(d8, dtype=np.int64)[0]
    with _Thresholds(router_min, small_max):
        jtp = jtpm.build_tile_plan(ids, d8.shape)
        tp = ttp.build_tile_plan(ids, d8.shape, device="cpu")
    assert type(jtp.coarse).__name__ == type(tp.coarse).__name__ == coarse_kind
    return dict(ids=ids, shape=d8.shape, jtp=_jit_banded(jtp), tp=tp, jax_banded={},
                thresholds=(router_min, small_max))


def plans_fixture(grids):
    """The module fixture ``plans`` over ``grids`` (names of ``_GRIDS``),
    built once a module: the gather level here, the router coarse levels in
    ``test_torch_tile_banded_router.py``, so that parallel workers share
    them out."""
    return pytest.fixture(scope="module", name="plans", params=list(grids))(_plans)


plans = plans_fixture(("300x260",))


def _data(kind, shape):
    if kind == "ones":
        return None
    return np.random.RandomState(61).randint(-5, 9, shape).astype(np.int32)


@pytest.mark.parametrize("band_tile_rows", [1, 2, None])
@pytest.mark.parametrize("kind", ["ones", "int32"])
def test_banded_int_bitwise(plans, kind, band_tile_rows):
    jtp, tp, shape = plans["jtp"], plans["tp"], plans["shape"]
    data = _data(kind, shape)
    key = (kind, band_tile_rows)
    if key not in plans["jax_banded"]:
        plans["jax_banded"][key] = np.asarray(jtp.accumulate_banded(data, band_tile_rows))
    want = plans["jax_banded"][key]
    flat = (torch.ones(shape[0] * shape[1], dtype=torch.int32) if data is None
            else torch.as_tensor(data.ravel()))
    mono = tp.accumulate(flat).numpy().reshape(shape)

    kernels.reset_launches()
    got = tp.accumulate_banded(data, band_tile_rows=band_tile_rows)
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    assert got.dtype == np.int32 and got.shape == shape
    assert np.array_equal(got, want) and np.array_equal(got, mono)

    parts = []
    ret = tp.accumulate_banded(data, band_tile_rows, out_cb=lambda b, r0, a: parts.append(
        (b, r0, a.copy())))
    assert ret is None
    btr = band_tile_rows or tp.grid[0]
    nb = -(-tp.grid[0] // btr)
    assert [p[0] for p in parts] == list(range(nb))  # bands in order
    assert [p[1] for p in parts] == [b * btr * 128 for b in range(nb)]
    assert all(a.shape[1] == shape[1] and a.dtype == np.int32 for _, _, a in parts)
    assert sum(a.shape[0] for _, _, a in parts) == shape[0]  # rows add up
    assert np.array_equal(np.concatenate([a for _, _, a in parts]), got)


def test_banded_float64_close(plans):
    ids, tp, shape = plans["ids"], plans["tp"], plans["shape"]
    w = np.random.RandomState(7).rand(*shape)
    got = tp.accumulate_banded(w, band_tile_rows=1)
    assert got.dtype == np.float64
    # the unfused passes sum in the fused ones' order
    assert np.array_equal(got.ravel(), tp.accumulate(torch.as_tensor(w.ravel())).numpy())
    want = np.asarray(jplan.accumulate_planned(jplan.build_plan(ids, fast=False),
                                               jnp.asarray(w.ravel())))
    total = w.ravel()[ids >= 0].sum()
    np.testing.assert_allclose(got.ravel(), want, rtol=1e-12, atol=2 * ids.size * _EPS * total)
    # float32 data comes back float32, summed in float64
    got32 = tp.accumulate_banded(w.astype(np.float32), band_tile_rows=2)
    assert got32.dtype == np.float32
    assert np.array_equal(got32.ravel(), tp.accumulate(
        torch.as_tensor(w.astype(np.float32).ravel())).numpy())


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_unfused_passes_match_jax_tiles(plans, dtype):
    """Rows 7 and 8: T1 in exits-only mode and T2 in full mode (plain
    versions) on the second band of two tile rows, against the JAX
    package's ``_pass_a_tiles`` and ``_pass_c_tiles`` on the same band."""
    jtp, tp = plans["jtp"], plans["tp"]
    H, W = tp.shape
    nty, ntx = tp.grid
    ty0, ty1 = (2, min(4, nty)) if nty > 2 else (0, nty)
    t0, t1 = ty0 * ntx, ty1 * ntx
    r0, r1 = ty0 * 128, min(ty1 * 128, H)
    x = np.random.RandomState(9).randint(0, 7, (H, W)).astype(dtype)
    cfg = jtp._acc_cfg(x.dtype)
    # the JAX band: (NT', 128, 128) tiles of the zero-padded rows
    blk = np.zeros(((ty1 - ty0) * 128, tp.pshape[1]), dtype)
    blk[: r1 - r0, :W] = x[r0:r1]
    xt = jnp.asarray(blk.reshape(ty1 - ty0, 128, ntx, 128).transpose(0, 2, 1, 3)
                     .reshape(t1 - t0, 128, 128)).astype(cfg["acc"])
    tabs = {k: jnp.asarray(jtp._tabs_np[k][t0:t1])
            for k in set(jtp._keys("a")) | set(jtp._keys("c"))}
    ex_j = np.asarray(jtp._pass_a_tiles(xt, tabs, cfg)).reshape(t1 - t0, -1)

    xb = torch.as_tensor(x[r0:r1].ravel())
    t = {k: torch.as_tensor(v[t0:t1]) for k, v in tp.idx.items()}
    ex_t = kernels.tile_pass_a(xb, t["rin"], t["ex_end"], (r1 - r0, W), emit_c=False)
    assert isinstance(ex_t, torch.Tensor) and ex_t.dtype == xb.dtype
    assert torch.equal(ex_t, kernels.tile_pass_a(xb, t["rin"], t["ex_end"], (r1 - r0, W))[0])
    real = np.arange(tp.R_pad)[None, :] < jtp._root_np[0][t0:t1, None]
    assert np.array_equal(ex_t.numpy()[real], ex_j[real])

    # entry inflows of the whole grid from the JAX coarse level
    xg = jnp.pad(jnp.asarray(x).astype(cfg["acc"]),
                 ((0, tp.pshape[0] - H), (0, tp.pshape[1] - W)))
    ex_all, _ = jtp._pass_a_fused(xg, jtp.arrays(), cfg)
    entv = np.asarray(jtp.coarse.accumulate(ex_all.reshape(-1), jtp.arrays()["coarse"]))
    E = jtp.E_rows * 128
    ent = np.zeros(tp.NT * E, entv.dtype)
    ent[: min(entv.size, ent.size)] = entv[: ent.size]
    ent = ent.reshape(tp.NT, E)
    out_j = np.asarray(jtp._pass_c_tiles(
        xt, jnp.asarray(ent[t0:t1].reshape(t1 - t0, -1, 128)), tabs, cfg))
    out_j = (out_j.reshape(ty1 - ty0, ntx, 128, 128).transpose(0, 2, 1, 3)
             .reshape((ty1 - ty0) * 128, -1)[: r1 - r0, :W])
    entv_t = torch.as_tensor(ent[t0:t1, : tp.E_pad].astype(dtype))
    args = (entv_t, t["ent_idx"], t["near_end"], t["far_end"], t["rout"], (r1 - r0, W))
    got = kernels.tile_pass_c(xb, None, *args, rin=t["rin"])
    assert got.dtype == xb.dtype
    assert np.array_equal(got.numpy(), out_j.ravel())
    # the full mode equals the fused pass C on pass A's c
    c = kernels.tile_pass_a(xb, t["rin"], t["ex_end"], (r1 - r0, W))[1]
    assert torch.equal(got, kernels.tile_pass_c(xb, c, *args))


@pytest.mark.parametrize("kind", ["int64_wide", "bool"])
def test_banded_memmap_sums_as_accumulate(plans, kind, tmp_path):
    """An ``np.memmap`` of 64-bit integers whose ``|max| * n`` reaches 2^31
    (int64 sums, ``|max|`` found band by band on the host) and one of bool
    data (int32 sums): a banded call sums in the dtype :meth:`accumulate`
    sums the same data in, and gives its result."""
    tp, shape = plans["tp"], plans["shape"]
    rng = np.random.RandomState(63)
    data = {"int64_wide": rng.randint(0, 1 << 20, shape).astype(np.int64),
            "bool": rng.rand(*shape) < 0.3}[kind]
    path = tmp_path / "data.bin"
    np.memmap(path, dtype=data.dtype, mode="w+", shape=shape)[:] = data
    mm = np.memmap(path, dtype=data.dtype, mode="r", shape=shape)
    flat = torch.as_tensor(data.ravel())
    acc = kernels.acc_dtype(flat)
    assert acc == (torch.int64 if kind == "int64_wide" else torch.int32)
    assert tp._banded_dtypes(mm, 128) == (flat.dtype, acc)
    got = tp.accumulate_banded(mm, band_tile_rows=1)
    assert got.dtype == data.dtype and got.shape == shape
    assert np.array_equal(got.ravel(), tp.accumulate(flat).numpy())


def test_banded_leaves_the_tables_on_the_host(plans):
    """A banded call on a fresh plan uploads no whole table; the first
    monolithic call does."""
    with _Thresholds(*plans["thresholds"]):
        tp = ttp.build_tile_plan(plans["ids"], plans["shape"], device="cpu")
    assert tp._idx_t is None and tp.upload_seconds is None
    got = tp.accumulate_banded(None, band_tile_rows=1)
    assert tp._idx_t is None and tp.down_idx is None
    ones = torch.ones(plans["ids"].size, dtype=torch.int32)
    assert np.array_equal(tp.accumulate(ones).numpy(), got.ravel())
    assert set(tp._idx_t) == set(tp.idx) and tp.upload_seconds is not None
    with pytest.raises(ValueError, match="band_tile_rows"):
        tp.accumulate_banded(None, band_tile_rows=0)
    with pytest.raises(ValueError, match="shape"):
        tp.accumulate_banded(np.ones((3, 3), np.int32))
