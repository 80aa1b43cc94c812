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
