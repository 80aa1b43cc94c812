"""Port router (one int32 gather per permutation) against the JAX
package's 5-stage router: bitwise equal permutations, and the JAX stage
tables composed back into sigma."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyflwdir_torch import kernels
from pyflwdir_torch.ops import router as trouter
from pyflwdir_tpu.ops import router as jrouter

_S = 128


@pytest.fixture(scope="module", params=[1, 2, 5])
def case(request):
    G = request.param
    rng = np.random.RandomState(10 + G)
    n = G * _S * _S
    sigma = rng.permutation(n)
    x = rng.randint(-(2**20), 2**20, n).astype(np.float32).reshape(G * _S, _S)
    return G, sigma, x, jrouter.RouterPlan.build(sigma)


def test_apply_bitwise(case):
    G, sigma, x, jr = case
    tr = trouter.RouterPlan(sigma, device="cpu")
    got = tr.apply(torch.as_tensor(x)).numpy()
    want = np.asarray(jr.apply(jnp.asarray(x)))
    assert got.shape == x.shape
    assert np.array_equal(got.ravel(), x.ravel()[sigma])
    assert np.array_equal(got, want)
    assert np.array_equal(tr.apply_np(x), got)


def test_from_stage_tables(case):
    G, sigma, x, jr = case
    tr = trouter.RouterPlan.from_stage_tables(
        jr.G, jr.i1_np, jr.iS1_np, jr.iGp_np, jr.iS2_np, jr.i3_np, device="cpu"
    )
    assert tr.G == G
    assert np.array_equal(tr.sigma_np, sigma)
    assert tr.sigma.dtype == torch.int32


def test_lane_gather_bitwise(case):
    G, _, x, _ = case
    rng = np.random.RandomState(G)
    idx = rng.randint(0, _S, x.shape).astype(np.int8)
    want = np.asarray(jrouter._ta(jnp.asarray(x), jnp.asarray(idx)))
    got = trouter.lane_gather(torch.as_tensor(x), idx).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (3, 5), (5, 3), (7, 127)])
def test_lane_gather_bitwise_odd_lengths(shape, dtype):
    """The JAX ``_ta`` at lengths off the 128-lane layout: the flat gathers
    H0 takes, with n % 4 tails, against the port's lane gather."""
    rng = np.random.RandomState(shape[0] * 1000 + shape[1])
    x = rng.randint(-(2**20), 2**20, shape).astype(dtype)
    idx = rng.randint(0, shape[1], shape).astype(np.int8)
    want = np.asarray(jrouter._ta(jnp.asarray(x), jnp.asarray(idx)))
    got = trouter.lane_gather(torch.as_tensor(x), idx).numpy()
    assert got.dtype == x.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_permute_gather_plain_reads_zero_at_minus_one(n, dtype):
    """H0's plain version at the kernel's short lengths, with -1 entries at
    the head and the tail, against numpy."""
    rng = np.random.RandomState(n)
    x = rng.randint(1, 100, 7)
    src = rng.randint(0, 7, n).astype(np.int32)
    src[0] = src[-1] = -1
    got = kernels.permute_gather(torch.as_tensor(x).to(dtype), torch.as_tensor(src))
    want = np.where(src >= 0, x[np.maximum(src, 0)], 0)
    assert got.dtype == dtype and got.shape == (n,)
    assert np.array_equal(got.numpy(), want.astype(got.numpy().dtype))


def test_rejects_non_permutation():
    bad = np.zeros(_S * _S, dtype=np.int64)
    with pytest.raises(ValueError):
        trouter.RouterPlan(bad, device="cpu")
    with pytest.raises(ValueError):
        trouter.RouterPlan(np.arange(100), device="cpu")


def test_cpu_tensors_take_the_plain_version():
    kernels.reset_launches()
    trouter.RouterPlan(np.arange(_S * _S), device="cpu").apply(torch.zeros(_S, _S))
    assert kernels.launches["permute_gather"] == 0


@pytest.mark.parametrize("n,deg", [(7, 1), (50, 2), (64, 4), (33, 8)])
def test_bipartite_color(n, deg):
    """``bipartite_color`` (the shared native library) equals the JAX
    package's and its Python version on a random deg-regular bipartite
    multigraph, and colours it properly: each vertex meets each colour
    once."""
    rng = np.random.RandomState(n + deg)
    u = np.concatenate([np.arange(n)] * deg)
    v = np.concatenate([rng.permutation(n) for _ in range(deg)])
    got = trouter.bipartite_color(u, v, n, n, deg)
    assert got.dtype == np.int32
    assert np.array_equal(got, jrouter.bipartite_color(u, v, n, n, deg))
    assert np.array_equal(got, trouter._bipartite_color_py(u, v, n, n, deg))
    for side in (u, v):
        assert np.array_equal(np.sort(side * deg + got), np.arange(n * deg))


def test_router_tables_match_the_jax_runtime():
    """``runtime.tile_fwd_tables`` / ``tile_inv_rows`` bound by the port
    equal the JAX package's bindings of the same native functions."""
    from pyflwdir_torch import runtime
    from pyflwdir_tpu import runtime as jruntime

    rng = np.random.RandomState(3)
    for G in (1, 2):  # per-tile permutations of G * 128 rows of 128 lanes
        Y = G * _S
        sig = np.stack([rng.permutation(Y * _S) for _ in range(3)]).astype(np.int32)
        got, want = runtime.tile_fwd_tables(sig, Y, G), jruntime.tile_fwd_tables(sig, Y, G)
        assert (got[4] is None) == (want[4] is None) == (G == 1)
        for g, w in zip(got[:4] + got[4:] * (G > 1), want[:4] + want[4:] * (G > 1)):
            assert g.dtype == np.int8 and np.array_equal(g, w)
    with pytest.raises(ValueError):  # 32 rows: not a whole number of 128 x 128 groups
        runtime.tile_fwd_tables(sig[:, : 32 * _S], 32, 1)
    t = np.stack([rng.permutation(_S) for _ in range(20)]).astype(np.int8)
    assert np.array_equal(runtime.tile_inv_rows(t), jruntime.tile_inv_rows(t))
    assert np.array_equal(np.take_along_axis(t, runtime.tile_inv_rows(t).astype(np.int64), 1),
                          np.broadcast_to(np.arange(_S), t.shape))
