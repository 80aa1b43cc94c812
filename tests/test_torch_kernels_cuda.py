"""The CUDA kernels against their plain versions on the card: bitwise for
permutations and for integer-valued scans. Skips where there is no GPU."""

import numpy as np
import pytest
import torch

from pyflwdir_torch import kernels
from pyflwdir_torch.ops import accel as taccel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_permute_gather(dev):
    rng = np.random.RandomState(0)
    n = 3 * 128 * 128
    x = torch.as_tensor(rng.rand(n).astype(np.float32), device=dev)
    src = torch.as_tensor(rng.permutation(n).astype(np.int32), device=dev)
    kernels.reset_launches()
    got = kernels.permute_gather(x, src)
    assert kernels.launches["permute_gather"] == 1
    assert torch.equal(got, kernels.permute_gather_plain(x, src))


@pytest.mark.parametrize("n_x,n", [(1, 2048), (5000, 16384), (600_000, 688_128)])
def test_accel_in_scan(dev, n_x, n):
    rng = np.random.RandomState(1)
    x = torch.as_tensor(rng.randint(0, 3, n_x).astype(np.float32), device=dev)
    sig = torch.as_tensor(rng.permutation(n).astype(np.int32), device=dev)
    got = kernels.accel_in_scan(x, sig)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.accel_in_scan_plain(x, sig))


def test_accel_plan_matches_plain(dev):
    from pyflwdir_torch import dem
    from pyflwdir_torch.codecs import d8

    rng = np.random.RandomState(7)
    z = rng.rand(256, 384) + np.add.outer(np.linspace(2, 0, 256), np.linspace(2, 0, 384))
    ids = d8.from_array(dem.fill_depressions(z)[1], dtype=np.int64)[0]
    cpu = taccel.build_accel_plan(ids, device="cpu")
    gpu = taccel.build_accel_plan(ids, device=dev)
    assert gpu.has_far
    x = torch.ones(ids.size, dtype=torch.int32)
    kernels.reset_launches()
    got = gpu.accumulate(x.to(dev)).cpu()
    assert all(v == 1 for v in kernels.launches.values())
    assert torch.equal(got, cpu.accumulate(x))
