"""Port RouterPlanBig against the JAX package's: the one int32 index composed
from a JAX plan's seven stage tables equals the permutation the plan was
built for, and applying it (kernel H0's plain version on the CPU) equals the
JAX chain bitwise. The JAX plan is coloured once per module, at G1 = 1; a
G1 = 2 permutation runs through the port alone (it needs no colouring)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyflwdir_torch import kernels
from pyflwdir_torch.ops import router as trouter
from pyflwdir_torch.ops import router_big as tbig
from pyflwdir_tpu.ops import router_big as jbig

_CHUNK = 1 << 21


@pytest.fixture(scope="module")
def routed():
    rng = np.random.RandomState(0)
    sigma = rng.permutation(_CHUNK)
    jp = jbig.RouterPlanBig.build(sigma)
    return sigma, jp, tbig.RouterPlanBig.from_stage_tables(jp.G1, *jp._np, device="cpu")


def test_from_stage_tables_gives_sigma_back(routed):
    sigma, jp, tp = routed
    assert tp.G1 == jp.G1 == 1
    assert tp.sigma_np.dtype == np.int32 and tp.sigma.dtype == torch.int32
    assert np.array_equal(tp.sigma_np, sigma)
    native = tbig.RouterPlanBig(sigma, device="cpu")
    assert np.array_equal(native.sigma_np, tp.sigma_np)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64, np.int64])
def test_apply_equals_the_jax_chain_bitwise(routed, dtype):
    sigma, jp, tp = routed
    x = (np.random.RandomState(1).rand(_CHUNK) * 1000).astype(dtype).reshape(-1, 128)
    want = np.asarray(jp.apply(jnp.asarray(x)))
    kernels.reset_launches()
    got = tp.apply(torch.as_tensor(x))
    assert sum(kernels.launches.values()) == 0  # CPU tensors: the plain version
    assert got.shape == x.shape and got.numpy().dtype == dtype
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy().ravel(), x.ravel()[sigma])
    assert np.array_equal(tp.apply_np(x), want)


def test_inverse_round_trips(routed):
    sigma, jp, tp = routed
    inv = tp.inverse()
    x = torch.as_tensor(np.random.RandomState(2).randint(0, 1 << 30, _CHUNK).astype(np.int32))
    x2 = x.reshape(-1, 128)
    assert torch.equal(inv.apply(tp.apply(x2)), x2)
    assert torch.equal(tp.apply(inv.apply(x2)), x2)
    # the JAX plan's inverse (its tables inverted row by row) is the same map
    ji = jp.inverse()
    ti = tbig.RouterPlanBig.from_stage_tables(ji.G1, *ji._np, device="cpu")
    assert np.array_equal(ti.sigma_np, inv.sigma_np)


def test_two_chunks_without_colouring():
    rng = np.random.RandomState(3)
    sigma = rng.permutation(2 * _CHUNK)
    tp = tbig.RouterPlanBig(sigma, device="cpu")
    assert tp.G1 == 2
    x = torch.as_tensor(rng.rand(2 * _CHUNK)).reshape(-1, 128)
    got = tp.apply(x)
    assert np.array_equal(got.numpy().ravel(), x.numpy().ravel()[sigma])
    assert torch.equal(tp.inverse().apply(got), x)


def test_constructor_checks():
    with pytest.raises(ValueError, match="multiple of 2\\^21"):
        tbig.RouterPlanBig(np.arange(1 << 14), device="cpu")
    # 129 chunks, never materialised
    with pytest.raises(ValueError, match="big router supports up to 268435456"):
        tbig.RouterPlanBig(np.broadcast_to(np.int64(0), (129 * _CHUNK,)), device="cpu")
    bad = np.arange(_CHUNK)
    bad[5] = 6
    with pytest.raises(ValueError, match="not a permutation"):
        tbig.RouterPlanBig(bad, device="cpu")


def test_lane_gather_tiled_is_the_lane_gather():
    assert tbig.lane_gather_tiled is trouter.LaneGather
    rng = np.random.RandomState(4)
    x = rng.rand(300, 256)
    idx = rng.randint(0, 256, (300, 256))
    got = tbig.lane_gather_tiled(idx)(torch.as_tensor(x))
    want = np.asarray(jbig.lane_gather_tiled(jnp.asarray(x), jnp.asarray(idx)))
    assert np.array_equal(got.numpy(), want)


def test_router_sigma_reads_both_kinds_of_tables(routed):
    sigma, jp, _ = routed
    assert np.array_equal(tbig.router_sigma({"G1": jp.G1, "r": tuple(jp._np)}, "r"), sigma)
    from pyflwdir_tpu.ops import router as jrouter

    sig5 = np.random.RandomState(5).permutation(2 * 128 * 128)
    j5 = jrouter.RouterPlan.build(sig5)
    tabs = {"G": j5.G, "r": (j5.i1_np, j5.iS1_np, j5.iGp_np, j5.iS2_np, j5.i3_np)}
    assert np.array_equal(tbig.router_sigma(tabs, "r"), sig5)
