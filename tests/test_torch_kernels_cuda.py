"""The CUDA kernels against their plain versions on the card: bitwise for
permutations and integer data, float64 within the rounding of sums taken
in another order (rtol 1e-12, atol 2 n eps total). Skips where there is no
GPU."""

import numpy as np
import pytest
import torch

from pyflwdir_torch import kernels
from pyflwdir_torch.ops import accel as taccel
from pyflwdir_torch.ops import tile_plan as ttp

pytestmark = pytest.mark.cuda

_EPS = np.finfo(np.float64).eps


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _demo_ids(shape, seed=7, missing=False):
    from pyflwdir_torch import dem
    from pyflwdir_torch.codecs import d8

    rng = np.random.RandomState(seed)
    z = rng.rand(*shape) + np.add.outer(np.linspace(2, 0, shape[0]),
                                        np.linspace(2, 0, shape[1]))
    fd = dem.fill_depressions(z)[1]
    if missing:
        fd[1, 2:5] = 247
    return d8.from_array(fd, dtype=np.int64)[0]


def _data(rng, n, dtype):
    """float64 uniform in [0, 1); other types small integers (float32 sums
    are exact only for integer values with totals below 2^24)."""
    if dtype == torch.float64:
        return torch.as_tensor(rng.rand(n))
    return torch.as_tensor(rng.randint(0, 3, n)).to(dtype)


def _assert_match(got, want, total):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float64:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-12,
                                   atol=2 * want.numel() * _EPS * total)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64, torch.float64])
def test_permute_gather(dev, dtype):
    rng = np.random.RandomState(0)
    n = 3 * 128 * 128
    x = _data(rng, n, dtype).to(dev)
    src = torch.as_tensor(rng.permutation(n).astype(np.int32), device=dev)
    kernels.reset_launches()
    got = kernels.permute_gather(x, src)
    assert kernels.launches["permute_gather"] == 1
    assert torch.equal(got, kernels.permute_gather_plain(x, src))


@pytest.mark.parametrize("n_x,n", [(1, 2048), (5000, 16384), (600_000, 688_128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64, torch.float64])
def test_accel_in_scan(dev, n_x, n, dtype):
    rng = np.random.RandomState(1)
    x = _data(rng, n_x, dtype).to(dev)
    sig = torch.as_tensor(rng.permutation(n).astype(np.int32), device=dev)
    got = kernels.accel_in_scan(x, sig)
    _assert_match(got, kernels.accel_in_scan_plain(x, sig), float(x.double().sum()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64, torch.float64])
def test_accel_near_out_and_far_merge(dev, dtype):
    rng = np.random.RandomState(2)
    n = 4 * 128 * 128
    c = torch.cumsum(_data(rng, n, dtype), 0, dtype=dtype).to(dev)
    near = rng.randint(-1, n, n).astype(np.int32)
    got = kernels.accel_near_out(c, torch.as_tensor(near, device=dev))
    assert torch.equal(got, kernels.accel_near_out_plain(c, torch.as_tensor(near, device=dev)))
    far = torch.as_tensor(rng.randint(-2, n, n - 100).astype(np.int32), device=dev)
    x = _data(rng, n - 100, dtype).to(dev)
    for xx in (x, None):  # off-tree cells pass x through, or give 0
        res = kernels.accel_far_merge(got, xx, c, far)
        assert torch.equal(res, kernels.accel_far_merge_plain(got, xx, c, far))


def test_accel_plan_matches_plain(dev):
    ids = _demo_ids((256, 384))
    cpu = taccel.build_accel_plan(ids, device="cpu")
    gpu = taccel.build_accel_plan(ids, device=dev)
    assert gpu.has_far
    x = torch.ones(ids.size, dtype=torch.int32)
    kernels.reset_launches()
    got = gpu.accumulate(x.to(dev)).cpu()
    for name in ("permute_gather", "accel_in_scan", "accel_near_out", "accel_far_merge"):
        assert kernels.launches[name] == 1, name
    assert torch.equal(got, cpu.accumulate(x))


@pytest.fixture(scope="module")
def tile_plans():
    """One 300 x 200 tile plan (6 tiles, ragged edges) on the card and on the
    CPU, with the router coarse level forced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ids = _demo_ids((300, 200), seed=3, missing=True)
    old = ttp._COARSE_ROUTER_MIN
    ttp._COARSE_ROUTER_MIN = 1
    try:
        gpu = ttp.build_tile_plan(ids, (300, 200), device="cuda")
        cpu = ttp.build_tile_plan(ids, (300, 200), device="cpu")
    finally:
        ttp._COARSE_ROUTER_MIN = old
    assert isinstance(gpu.coarse, ttp._CoarseRouterSmall)
    return ids, gpu, cpu


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tile_pass_a_and_c(tile_plans, dtype):
    ids, gpu, _ = tile_plans
    t = gpu.idx_t
    rng = np.random.RandomState(3)
    x = _data(rng, ids.size, dtype).to("cuda")
    total = float(x.double().sum())
    kernels.reset_launches()
    exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], gpu.shape)
    assert kernels.launches["tile_pass_a"] == 1
    ex_p, c_p = kernels.tile_pass_a_plain(x, t["rin"], t["ex_end"], gpu.shape)
    _assert_match(c, c_p, total)
    _assert_match(exits, ex_p, total)
    entv = _data(rng, gpu.NT * gpu.E_pad, dtype).to("cuda").reshape(gpu.NT, gpu.E_pad)
    args = (x, c, entv, t["ent_idx"], t["near_end"], t["far_end"], t["rout"], gpu.shape)
    got = kernels.tile_pass_c(*args)
    assert kernels.launches["tile_pass_c"] == 1
    _assert_match(got, kernels.tile_pass_c_plain(*args), total + float(entv.double().sum()))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_tile_plan_matches_cpu(tile_plans, dtype):
    ids, gpu, cpu = tile_plans
    rng = np.random.RandomState(4)
    x = _data(rng, ids.size, dtype)
    kernels.reset_launches()
    got = gpu.accumulate(x.to("cuda")).cpu()
    assert all(v == 1 for v in kernels.launches.values()), kernels.launches
    _assert_match(got, cpu.accumulate(x), float(x.double().sum()))

