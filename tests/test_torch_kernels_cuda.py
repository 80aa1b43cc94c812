"""The CUDA kernels against their plain versions on the card: bitwise for
permutations and integer data, float64 within the rounding of sums taken
in another order (rtol 1e-12, atol 2 L eps total, L the additions on the
longest chain of those sums, or n), and the same bits from
run to run. Skips where there is no GPU."""

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


def _assert_match(got, want, total, length=None):
    """Bitwise, or for float64 within rtol 1e-12 and 2 L eps total: L
    ``length``, the additions on the longest chain of the sums taken in
    another order, or at most every element."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float64:
        length = want.numel() if length is None else length
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-12,
                                   atol=2 * length * _EPS * total)
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


# H1 lengths, by the kernel's geometry (tile = threads * slots a thread, W
# tiles a window): (tiles, slots past them)
_SCAN_LENGTHS = {"one": (0, 1), "tile-1": (1, -1), "tile": (1, 0), "tile+1": (1, 1),
                 "window-1": ("W", -1), "window": ("W", 0), "window+3": ("W", 3),
                 "two windows+5": ("2W", 5), "2^24+3": (None, (1 << 24) + 3)}


def _scan_n(case, dtype):
    threads, per, window = kernels._scan_geometry(dtype)
    tiles, rest = _SCAN_LENGTHS[case]
    tiles = {"W": window, "2W": 2 * window, None: 0}.get(tiles, tiles)
    return tiles * threads * per + rest


@pytest.mark.parametrize("case", list(_SCAN_LENGTHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64, torch.float64])
def test_accel_in_scan(dev, case, dtype):
    """H1 at ragged lengths around its tile and window, from 1 slot past
    2^24; a third of the sources lie at or past n_x (0) and some at n_pad,
    the most the index holds. float64 within the kernel's chain of
    additions, twice over (the plain cumsum rounds in another order)."""
    n = _scan_n(case, dtype)
    rng = np.random.RandomState(n % 1000)
    n_x = max(1, 2 * n // 3)
    x = _data(rng, n_x, dtype).to(dev)
    sig_np = rng.permutation(n).astype(np.int32)
    sig_np[rng.rand(n) < 0.01] = n
    sig = torch.as_tensor(sig_np, device=dev)
    kernels.reset_launches()
    got = kernels.accel_in_scan(x, sig)
    assert kernels.launches["accel_in_scan"] == 1 and sum(kernels.launches.values()) == 1
    _assert_match(got, kernels.accel_in_scan_plain(x, sig), float(x.double().sum()),
                  length=2 * kernels.accel_in_scan_chain(n, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_accel_in_scan_same_bits(dev, dtype):
    """Two calls on one input give the same bits: the window look-back sums
    in one order whatever the blocks' timing."""
    n = (1 << 24) + 3
    rng = np.random.RandomState(8)
    x = torch.as_tensor(rng.rand(n), device=dev).to(dtype)
    sig = torch.as_tensor(rng.permutation(n).astype(np.int32), device=dev)
    a = kernels.accel_in_scan(x, sig)
    for _ in range(3):
        b = kernels.accel_in_scan(x, sig)
        assert torch.equal(a.view(torch.int32 if dtype == torch.float32 else torch.int64),
                           b.view(torch.int32 if dtype == torch.float32 else torch.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64, torch.float64])
def test_accel_near_out_and_far_merge(dev, dtype):
    """H2 on random interval ends and H3, the permute-merge, on random
    sources (-1 off the tree) with off-tree outputs passing x through or
    giving 0, each bitwise against its plain version."""
    rng = np.random.RandomState(2)
    n = 4 * 128 * 128
    c = torch.cumsum(_data(rng, n, dtype), 0, dtype=dtype).to(dev)
    end = torch.as_tensor(rng.randint(-1, n, n).astype(np.int32), device=dev)
    kernels.reset_launches()
    outp = kernels.accel_near_out(c, end)
    assert torch.equal(outp, kernels.accel_near_out_plain(c, end))
    n_out = n - 100
    src_res = torch.as_tensor(rng.randint(-1, n, n_out).astype(np.int32), device=dev)
    x = _data(rng, n_out, dtype).to(dev)
    for xx in (x, None):  # off-tree outputs pass x through, or give 0
        res = kernels.accel_far_merge(outp, xx, src_res)
        assert torch.equal(res, kernels.accel_far_merge_plain(outp, xx, src_res))
    assert kernels.launches["accel_near_out"] == 1 and kernels.launches["accel_far_merge"] == 2
    assert sum(kernels.launches.values()) == 3


def _bits(t):
    return t.view(torch.int64).cpu()


def test_signed_zeros_through_h2_and_h3(dev):
    """float64 with signed zeros: H1's prefix sums hold no -0 (each has a
    +0 at its root), H2 and H3 give the plain versions' bits, sign bits
    included, and the sweep gives the bits of the split far add it
    replaced, out + c[far_end] after outp = 0 - c[k-1], on the same c."""
    rng = np.random.RandomState(9)
    n = 3 * 128 * 128
    x = torch.zeros(n, dtype=torch.float64)
    x[rng.rand(n) < 0.5] = -0.0
    x[rng.rand(n) < 0.01] = 1.0
    x[: 5000] = -0.0  # a run of -0 at the head
    x = x.to(dev)
    sig = torch.as_tensor(rng.permutation(n).astype(np.int32), device=dev)
    sig[:4000] = torch.arange(4000, dtype=torch.int32, device=dev)  # leading -0 slots
    c = kernels.accel_in_scan(x, sig)
    neg0 = torch.tensor(-0.0, dtype=torch.float64).view(torch.int64).item()
    assert not (_bits(c) == neg0).any()
    k = torch.arange(n, device=dev)
    span = torch.as_tensor(rng.randint(0, 400, n), device=dev)
    end = torch.where(torch.as_tensor(rng.rand(n) < 0.9, device=dev),
                      torch.clamp(k + span, max=n - 1), -1).to(torch.int32)
    outp = kernels.accel_near_out(c, end)
    assert torch.equal(_bits(outp), _bits(kernels.accel_near_out_plain(c, end)))
    src_res = torch.as_tensor(rng.randint(-1, n, n).astype(np.int32), device=dev)
    xo = torch.where(torch.as_tensor(rng.rand(n) < 0.5, device=dev), -0.0, 0.0).to(torch.float64)
    for xx in (xo, None):
        res = kernels.accel_far_merge(outp, xx, src_res)
        assert torch.equal(_bits(res), _bits(kernels.accel_far_merge_plain(outp, xx, src_res)))
    # the earlier composition: near ends in H2, far ends added after the
    # permutation (k = 0 reads +0 for c[-1], as both kernels do)
    far = (end.long() - k >= 128) & (end >= 0)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    lo = torch.cat([zero.reshape(1), c[:-1]])
    old = torch.where(far, (zero - lo) + c[end.long().clamp(min=0)],
                      kernels.accel_near_out_plain(c, torch.where(far, -1, end)))
    assert torch.equal(_bits(outp), _bits(old))


def test_accel_plan_matches_plain(dev):
    ids = _demo_ids((256, 384))
    cpu = taccel.build_accel_plan(ids, device="cpu")
    gpu = taccel.build_accel_plan(ids, device=dev)
    assert gpu.has_far
    x = torch.ones(ids.size, dtype=torch.int32)
    kernels.reset_launches()
    got = gpu.accumulate(x.to(dev)).cpu()
    want = {"accel_in_scan": 1, "accel_near_out": 1, "accel_far_merge": 1}
    assert all(kernels.launches[k] == want.get(k, 0) for k in kernels.launches), kernels.launches
    assert torch.equal(got, cpu.accumulate(x))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_big_accel_plan_kernels_at_two_chunks(dev, dtype):
    """H1, H2 and H3 at 2^22 slots (a 1504 x 1504 graph's BigAccelPlan),
    each on the plan's own index against its plain version, H2 and H3
    bitwise against the composition they replaced (H2 on near ends, H0 to
    cells, far ends added), then the plan on the card against the plan on
    the CPU."""
    from pyflwdir_torch.ops import accel_big as tbig

    ids = _demo_ids((1504, 1504), seed=17, missing=True)
    cpu = taccel.build_accel_plan(ids, device="cpu")
    gpu = taccel.build_accel_plan(ids, device=dev)
    assert isinstance(gpu, tbig.BigAccelPlan) and gpu.n_pad == 1 << 22 and gpu.has_far
    x = _data(np.random.RandomState(4), ids.size, dtype)
    total = float(x.double().sum())
    xd, t = x.to(dev), gpu._t
    c = kernels.accel_in_scan(xd, t["src_in"])
    _assert_match(c, kernels.accel_in_scan_plain(xd, t["src_in"]), total,
                  length=2 * kernels.accel_in_scan_chain(gpu.n_pad, dtype))
    outp = kernels.accel_near_out(c, t["end"])
    assert torch.equal(outp, kernels.accel_near_out_plain(c, t["end"]))
    res = kernels.accel_far_merge(outp, xd, t["src_res"])
    assert torch.equal(res, kernels.accel_far_merge_plain(outp, xd, t["src_res"]))
    host = {k: torch.as_tensor(getattr(gpu, k), device=dev)
            for k in ("near_end", "src_out", "far_end")}
    out = kernels.permute_gather(kernels.accel_near_out(c, host["near_end"]), host["src_out"])
    fe = host["far_end"].long()
    old = torch.where(fe == -2, xd, torch.where(fe >= 0, out + c[fe.clamp(min=0)], out))
    bits = torch.int32 if dtype == torch.int32 else torch.int64
    assert torch.equal(res.view(bits), old.view(bits))
    kernels.reset_launches()
    got = gpu.accumulate(xd)
    want = {"accel_in_scan": 1, "accel_near_out": 1, "accel_far_merge": 1}
    assert all(kernels.launches[k] == want.get(k, 0) for k in kernels.launches), kernels.launches
    assert torch.equal(got, res)
    _assert_match(got.cpu(), cpu.accumulate(x), total)


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
    up = ("tile_pass_a", "accel_in_scan", "accel_near_out", "accel_far_merge", "tile_pass_c")
    assert all(kernels.launches[k] == (k in up) for k in kernels.launches), kernels.launches
    _assert_match(got, cpu.accumulate(x), float(x.double().sum()))


@pytest.fixture(scope="module")
def odd_plans():
    """A 301 x 1000 tile plan (3 x 8 tiles, ragged in both directions, the
    gather coarse level) on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ids = _demo_ids((301, 1000), seed=5, missing=True)
    gpu = ttp.build_tile_plan(ids, (301, 1000), device="cuda")
    cpu = ttp.build_tile_plan(ids, (301, 1000), device="cpu")
    return ids, gpu, cpu


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tile_pass_a_exits_and_c_full(odd_plans, dtype):
    """T1 in exits-only mode and T2 in full mode against their plain
    versions, and bitwise against the fused pair (the same scan), on the
    whole grid and on its second tile row as a band of its own."""
    ids, gpu, _ = odd_plans
    t = gpu.idx_t
    rng = np.random.RandomState(11)
    x = _data(rng, ids.size, dtype).to("cuda")
    entv = _data(rng, gpu.NT * gpu.E_pad, dtype).to("cuda").reshape(gpu.NT, gpu.E_pad)
    total = float(x.double().sum()) + float(entv.double().sum())
    ntx = gpu.grid[1]
    for rows, tiles in ((slice(0, 301), slice(0, gpu.NT)), (slice(128, 256), slice(ntx, 2 * ntx))):
        shape = (rows.stop - rows.start, 1000)
        xb = x.reshape(301, 1000)[rows].reshape(-1).contiguous()
        tb = {k: v[tiles].contiguous() for k, v in t.items()}
        eb = entv[tiles].contiguous()
        kernels.reset_launches()
        exits = kernels.tile_pass_a(xb, tb["rin"], tb["ex_end"], shape, emit_c=False)
        assert kernels.launches["tile_pass_a_exits"] == 1
        assert sum(kernels.launches.values()) == 1
        _assert_match(exits, kernels.tile_pass_a_plain(xb, tb["rin"], tb["ex_end"], shape,
                                                       emit_c=False), total)
        ex_f, c = kernels.tile_pass_a(xb, tb["rin"], tb["ex_end"], shape)
        assert torch.equal(exits, ex_f)
        args = (eb, tb["ent_idx"], tb["near_end"], tb["far_end"], tb["rout"], shape)
        kernels.reset_launches()
        got = kernels.tile_pass_c(xb, None, *args, rin=tb["rin"])
        assert kernels.launches["tile_pass_c_full"] == 1
        assert sum(kernels.launches.values()) == 1
        _assert_match(got, kernels.tile_pass_c_plain(xb, None, *args, rin=tb["rin"]), total)
        assert torch.equal(got, kernels.tile_pass_c(xb, c, *args))
        assert torch.equal(got, kernels.tile_pass_c(xb, None, *args, rin=tb["rin"]))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_banded_matches_cpu(odd_plans, dtype):
    ids, _, cpu = odd_plans
    fresh = ttp.build_tile_plan(ids, (301, 1000), device="cuda")
    x = _data(np.random.RandomState(12), ids.size, dtype).numpy().reshape(301, 1000)
    kernels.reset_launches()
    got = fresh.accumulate_banded(x, band_tile_rows=1)
    want = {"tile_pass_a_exits": 3, "tile_pass_c_full": 3}
    assert all(kernels.launches[k] == want.get(k, 0) for k in kernels.launches), kernels.launches
    assert fresh._idx_t is None  # no table uploaded whole
    assert np.array_equal(got, cpu.accumulate_banded(x, band_tile_rows=1)) or (
        dtype == torch.float64 and np.allclose(got, cpu.accumulate_banded(x, 1), rtol=1e-12,
                                               atol=2 * x.size * _EPS * np.abs(x).sum()))
    mono = fresh.accumulate(torch.as_tensor(x.ravel(), device="cuda")).cpu().numpy()
    assert np.array_equal(got.ravel(), mono)  # the fused passes' order
    parts = []
    fresh.accumulate_banded(x, 2, out_cb=lambda b, r0, a: parts.append((b, r0, a.copy())))
    assert [(b, r0) for b, r0, _ in parts] == [(0, 0), (1, 256)]
    assert np.array_equal(np.concatenate([a for _, _, a in parts]), got)
    assert np.array_equal(fresh.accumulate_banded(None, None).ravel(),
                          fresh.accumulate(torch.ones(ids.size, dtype=torch.int32,
                                                      device="cuda")).cpu().numpy())


def test_permute_gather_reads_zero_at_masked_indices(dev):
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.rand(5000), device=dev)
    src = torch.as_tensor(rng.randint(-1, 5000, 70_000).astype(np.int32), device=dev)
    got = kernels.permute_gather(x, src)
    assert torch.equal(got, kernels.permute_gather_plain(x, src))
    assert bool((got[src < 0] == 0).all()) and bool((src < 0).any())


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 3, 4, 5, (1 << 20) + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64, torch.float64])
def test_permute_gather_edges(dev, dtype, n, offset):
    """H0 at its edges: n % 4 tails and chunks of 1,024 slots cut short, src
    views that start 1 or 3 elements past a 16-byte boundary, and -1
    entries at the head and the tail."""
    rng = np.random.RandomState(n + offset)
    n_x = max(n, 7)
    x = _data(rng, n_x, dtype).to(dev)
    s = rng.randint(0, n_x, n + offset).astype(np.int32)
    s[offset] = s[-1] = -1
    src = torch.as_tensor(s, device=dev)[offset:]
    assert src.is_contiguous() and src.data_ptr() % 16 == 4 * offset
    kernels.reset_launches()
    got = kernels.permute_gather(x, src)
    assert kernels.launches["permute_gather"] == 1
    torch.cuda.synchronize()
    want = kernels.permute_gather_plain(x, src)
    assert got.dtype == dtype and torch.equal(got, want)
    assert got[0] == 0 and got[-1] == 0


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tile_down_a(tile_plans, dtype, routed):
    ids, gpu, _ = tile_plans
    gpu._ensure_down()
    t, d = gpu.idx_t, gpu.down_idx_t
    x = _data(np.random.RandomState(6), ids.size, dtype).to("cuda")
    args = (x, t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"],
            t["rout"] if routed else None, gpu.shape, routed)
    kernels.reset_launches()
    z, pk = kernels.tile_down_a(*args)
    assert kernels.launches["tile_down_a"] == 1
    z_p, pk_p = kernels.tile_down_a_plain(*args)
    total = float(x.double().sum())
    _assert_match(z, z_p, total)
    _assert_match(pk, pk_p, total)
    z2, pk2 = kernels.tile_down_a(*args)  # the same bits from run to run
    assert torch.equal(z, z2) and torch.equal(pk, pk2)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tile_down_fin(tile_plans, dtype):
    ids, gpu, _ = tile_plans
    gpu._ensure_down()
    t, d = gpu.idx_t, gpu.down_idx_t
    rng = np.random.RandomState(7)
    x = _data(rng, ids.size, dtype).to("cuda")
    z1 = _data(rng, gpu.NT * 128 * 128, dtype).to("cuda").reshape(gpu.NT, -1)
    A = _data(rng, gpu.NT * gpu.R_pad, dtype).to("cuda").reshape(gpu.NT, gpu.R_pad)
    args = (x, z1, A, d["tree_of"], t["rout"], gpu.shape)
    kernels.reset_launches()
    got = kernels.tile_down_fin(*args)
    assert kernels.launches["tile_down_fin"] == 1
    assert torch.equal(got, kernels.tile_down_fin_plain(*args))  # one add per cell


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_tile_plan_down_matches_cpu(tile_plans, dtype):
    ids, gpu, cpu = tile_plans
    x = _data(np.random.RandomState(8), ids.size, dtype)
    gpu._ensure_down()
    kernels.reset_launches()
    got = gpu.accumulate_down(x.to("cuda"))
    want = {"tile_down_a": 1, "accel_in_scan": 2, "permute_gather": 4, "tile_down_fin": 1}
    assert all(kernels.launches[k] == want.get(k, 0) for k in kernels.launches), kernels.launches
    assert torch.equal(got, gpu.accumulate_down(x.to("cuda")))
    _assert_match(got.cpu(), cpu.accumulate_down(x), float(x.double().sum()))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tile_down_lite(tile_plans, dtype):
    """T4's lite mode against its plain version, and bitwise against fin
    mode on the raw pass D1 of the same data (routing is a permutation)."""
    ids, gpu, _ = tile_plans
    gpu._ensure_down()
    t, d = gpu.idx_t, gpu.down_idx_t
    rng = np.random.RandomState(9)
    x = _data(rng, ids.size, dtype).to("cuda")
    A = _data(rng, gpu.NT * gpu.R_pad, dtype).to("cuda").reshape(gpu.NT, gpu.R_pad)
    d1 = (x, t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
    z1, _ = kernels.tile_down_a(*d1, None, gpu.shape, False)
    abar, _ = kernels.tile_down_a(*d1, t["rout"], gpu.shape, True)
    args = (abar, A, d["tree_of"], t["rout"], gpu.shape)
    kernels.reset_launches()
    got = kernels.tile_down_lite(*args)
    assert kernels.launches["tile_down_lite"] == 1 and sum(kernels.launches.values()) == 1
    assert torch.equal(got, kernels.tile_down_lite_plain(*args))  # one add per cell
    assert torch.equal(got, kernels.tile_down_fin(x, z1, A, d["tree_of"], t["rout"], gpu.shape))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tile_ranges(odd_plans, dtype):
    """T1, T2, T3 (routed) and T4 (fin and lite) on tile ranges that start
    and end in the middle of a tile row: bitwise the same slice of the
    whole-grid call, and their plain versions."""
    ids, gpu, _ = odd_plans
    gpu._ensure_down()
    t, d = gpu.idx_t, gpu.down_idx_t
    shape = gpu.shape
    rng = np.random.RandomState(13)
    x = _data(rng, ids.size, dtype).to("cuda")
    entv = _data(rng, gpu.NT * gpu.E_pad, dtype).to("cuda").reshape(gpu.NT, gpu.E_pad)
    A = _data(rng, gpu.NT * gpu.R_pad, dtype).to("cuda").reshape(gpu.NT, gpu.R_pad)
    total = float(x.double().sum()) + float(entv.double().sum())
    exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], shape)
    up = (t["ent_idx"], t["near_end"], t["far_end"], t["rout"])
    out = kernels._tiles(kernels.tile_pass_c(x, c, entv, *up, shape), shape)
    d1 = (t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
    z1, _ = kernels.tile_down_a(x, *d1, None, shape, False)
    abar, pk = kernels.tile_down_a(x, *d1, t["rout"], shape, True)
    lite = kernels.tile_down_lite(abar, A, d["tree_of"], t["rout"], shape)
    abar, lite = kernels._tiles(abar, shape), kernels._tiles(lite, shape)
    for lo, hi in ((5, 13), (13, gpu.NT)):
        s = slice(lo, hi)
        ex_r, c_r = kernels.tile_pass_a(x, t["rin"][s], t["ex_end"][s], shape, tile0=lo)
        assert torch.equal(ex_r, exits[s]) and torch.equal(c_r, c[s])
        got = kernels.tile_pass_c(x, c_r, entv[s], *(v[s] for v in up), shape, tile0=lo)
        assert got.shape == (hi - lo, 128 * 128) and torch.equal(got, out[s])
        _assert_match(got, kernels.tile_pass_c_plain(x, c_r, entv[s], *(v[s] for v in up), shape,
                                                     tile0=lo), total)
        ab_r, pk_r = kernels.tile_down_a(x, *(v[s] for v in d1), t["rout"][s], shape, True,
                                         tile0=lo)
        assert torch.equal(ab_r, abar[s]) and torch.equal(pk_r, pk[s])
        lite_args = (ab_r, A[s], d["tree_of"][s], t["rout"][s], shape)
        got = kernels.tile_down_lite(*lite_args, tile0=lo)
        assert torch.equal(got, lite[s])
        assert torch.equal(got, kernels.tile_down_lite_plain(*lite_args, tile0=lo))
        assert torch.equal(got, kernels.tile_down_fin(x, z1[s], A[s], d["tree_of"][s],
                                                      t["rout"][s], shape, tile0=lo))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_sharded_on_one_card(odd_plans, dtype):
    """The sharded sweeps on a mesh of this one process: bitwise the
    unsharded ones; T4 lite launched once a downward call."""
    from pyflwdir_torch import parallel

    ids, gpu, _ = odd_plans
    mesh = parallel.make_mesh()
    x = _data(np.random.RandomState(14), ids.size, dtype).to(mesh.device)
    gpu._ensure_down()
    assert torch.equal(gpu.accumulate_sharded(x, mesh, overlap_chunks=3), gpu.accumulate(x))
    kernels.reset_launches()
    got = gpu.accumulate_down_sharded(x, mesh)
    assert kernels.launches["tile_down_lite"] == 1 and kernels.launches["tile_down_a"] == 1
    assert torch.equal(got, gpu.accumulate_down(x))



_T = 128 * 128
_EDGE_SHAPE = (300, 400)  # 3 x 4 tiles, ragged in both directions
_EDGE_RANGE = (5, 11)  # tile row 1 column 1 to tile row 2 column 2


def _edge_tables(E, seed, dev):
    """Synthetic int16 tables of every tile kernel for the 12 tiles of a
    300 x 400 raster, within each table's range: rin and es permutations of a
    tile, the other slot tables -1 or a slot, ent_idx -1 or an entry rank
    below E (and 2^15); n_tree 0 in tile 0, 16,384 in tile 1."""
    assert _EDGE_SHAPE == (300, 400)  # 3 x 4 tiles
    NT = 12
    rng = np.random.RandomState(seed)

    def perm():
        return np.stack([rng.permutation(_T) for _ in range(NT)])

    def idx(hi, shape=(NT, _T), p_neg=0.3):
        a = rng.randint(0, max(hi, 1), shape)
        return np.where((rng.rand(*shape) < p_neg) | (hi == 0), -1, a)

    # cells past the raster's edge are off the tree (rout -1), as in a plan
    l = np.arange(_T)
    t = np.arange(NT)[:, None]
    H, W = _EDGE_SHAPE
    past = ((t // 4) * 128 + l // 128 >= H) | ((t % 4) * 128 + l % 128 >= W)
    tabs = dict(rin=perm(), es=perm(), rout=np.where(past, -1, idx(_T)), near_end=idx(_T),
                far_end=idx(_T, p_neg=0.8), ent_idx=idx(min(E, 1 << 15)), g_last=idx(_T),
                g_prev=idx(_T), ent_slot=idx(_T, (NT, E), 0.2), ex_end=idx(_T, (NT, 128), 0),
                tree_of=idx(300))
    tabs = {k: torch.as_tensor(v.astype(np.int16), device=dev) for k, v in tabs.items()}
    n_tree = rng.randint(0, _T + 1, NT)
    n_tree[:2] = 0, _T
    tabs["n_tree"] = torch.as_tensor(n_tree.astype(np.int32), device=dev)
    return tabs


def _edge_data(rng, n, dtype, dev):
    """Small integers; float64 integer-valued, so that every sum of the
    synthetic tables is exact in any order and the results compare bitwise."""
    return torch.as_tensor(rng.randint(0, 100, n)).to(dtype).to(dev)


@pytest.mark.parametrize("E", [0, 256, "max"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tile_pass_c_edges(dev, dtype, E):
    """T2 fused and full on synthetic tables, whole grid and on a tile range
    that starts and ends in the middle of a tile row, bitwise against the
    plain versions; full mode bitwise T1 + fused mode; E = 0, 256 and the
    largest E one block's shared memory takes (one more raises)."""
    esize = torch.empty((), dtype=dtype).element_size()
    max_e = kernels.load()["tile_kernels"].pf_tile_max_smem() // esize - _T
    E = max_e if E == "max" else E
    t = _edge_tables(E, 17, dev)
    rng = np.random.RandomState(18)
    H, W = shape = _EDGE_SHAPE
    x = _edge_data(rng, H * W, dtype, dev)
    c = _edge_data(rng, 12 * _T, dtype, dev).reshape(12, _T)
    entv = _edge_data(rng, 12 * E, dtype, dev).reshape(12, E)
    up = (t["ent_idx"], t["near_end"], t["far_end"], t["rout"])
    kernels.reset_launches()
    fused = kernels.tile_pass_c(x, c, entv, *up, shape)
    full = kernels.tile_pass_c(x, None, entv, *up, shape, rin=t["rin"])
    assert kernels.launches["tile_pass_c"] == kernels.launches["tile_pass_c_full"] == 1
    torch.cuda.synchronize()
    assert torch.equal(fused, kernels.tile_pass_c_plain(x, c, entv, *up, shape))
    assert torch.equal(full, kernels.tile_pass_c_plain(x, None, entv, *up, shape, rin=t["rin"]))
    _, c1 = kernels.tile_pass_a(x, t["rin"], t["ex_end"], shape)
    assert torch.equal(full, kernels.tile_pass_c(x, c1, entv, *up, shape))
    lo, hi = _EDGE_RANGE
    s = slice(lo, hi)
    for cc, rin, want in ((c, None, fused), (None, t["rin"], full)):
        args = (x, None if cc is None else cc[s], entv[s], *(v[s] for v in up), shape)
        kw = dict(rin=None if rin is None else rin[s], tile0=lo)
        got = kernels.tile_pass_c(*args, **kw)
        assert torch.equal(got, kernels._tiles(want, shape)[s])
        assert torch.equal(got, kernels.tile_pass_c_plain(*args, **kw))
    if E == max_e:
        entv = _edge_data(rng, 12 * (E + 1), dtype, dev).reshape(12, E + 1)
        with pytest.raises(ValueError, match="shared"):
            kernels.tile_pass_c(x, c, entv, *up, shape)


@pytest.mark.parametrize("E", [0, 300])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tile_down_a_edges(dev, dtype, E):
    """T3 raw and routed on synthetic tables (a tile with no tree slot, one
    all tree), whole grid and on a tile range that starts and ends in the
    middle of a tile row, bitwise against the plain versions."""
    t = _edge_tables(E, 19, dev)
    H, W = shape = _EDGE_SHAPE
    x = _edge_data(np.random.RandomState(20), H * W, dtype, dev)
    d1 = (x, t["rin"], t["es"], t["g_last"], t["g_prev"], t["n_tree"], t["ent_slot"])
    kernels.reset_launches()
    raw = kernels.tile_down_a(*d1, None, shape, False)
    routed = kernels.tile_down_a(*d1, t["rout"], shape, True)
    assert kernels.launches["tile_down_a"] == 2
    torch.cuda.synchronize()
    for got, want in zip((*raw, *routed), (*kernels.tile_down_a_plain(*d1, None, shape, False),
                                           *kernels.tile_down_a_plain(*d1, t["rout"], shape,
                                                                      True))):
        assert torch.equal(got, want)
    assert not raw[0][0].any() and raw[0].shape == (12, _T)  # tile 0 has no tree
    lo, hi = _EDGE_RANGE
    s = slice(lo, hi)
    args = (x, *(v[s] for v in d1[1:]), t["rout"][s], shape, True)
    got = kernels.tile_down_a(*args, tile0=lo)
    assert torch.equal(got[0], kernels._tiles(routed[0], shape)[s])
    assert torch.equal(got[1], routed[1][s])
    for g, w in zip(got, kernels.tile_down_a_plain(*args, tile0=lo)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["rin", "es", "g_last", "g_prev", "rout"])
def test_tile_down_a_rejects_unaligned_tables(dev, name):
    """T3 reads its slot tables a 32-bit word (two entries) at a time: a
    table that starts off a 4-byte boundary raises ValueError before any
    launch, and the card still runs T3 after it."""
    t = _edge_tables(0, 23, dev)
    shape = _EDGE_SHAPE
    x = _edge_data(np.random.RandomState(24), shape[0] * shape[1], torch.int32, dev)
    odd = torch.empty(t[name].numel() + 1, dtype=torch.int16, device=dev)[1:]
    odd.copy_(t[name].reshape(-1))
    bad = dict(t, **{name: odd.view(t[name].shape)})
    keys = ("rin", "es", "g_last", "g_prev", "n_tree", "ent_slot", "rout")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="4-byte boundary"):
        kernels.tile_down_a(x, *(bad[k] for k in keys), shape, True)
    assert kernels.launches["tile_down_a"] == 0
    args = (x, *(t[k] for k in keys), shape, True)
    for got, want in zip(kernels.tile_down_a(*args), kernels.tile_down_a_plain(*args)):
        assert torch.equal(got, want)


def test_float64_sweeps_repeat_bitwise(odd_plans):
    """T2 (fused, full, tile range) and T3 (raw, routed, tile range) on
    float64: two calls give the same bits."""
    ids, gpu, _ = odd_plans
    gpu._ensure_down()
    t, d = gpu.idx_t, gpu.down_idx_t
    rng = np.random.RandomState(21)
    x = torch.as_tensor(rng.rand(ids.size), device="cuda")
    entv = torch.as_tensor(rng.rand(gpu.NT, gpu.E_pad), device="cuda")
    _, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], gpu.shape)
    up = (t["ent_idx"], t["near_end"], t["far_end"], t["rout"])
    d1 = (x, t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
    calls = (lambda: kernels.tile_pass_c(x, c, entv, *up, gpu.shape),
             lambda: kernels.tile_pass_c(x, None, entv, *up, gpu.shape, rin=t["rin"]),
             lambda: kernels.tile_pass_c(x, c[3:], entv[3:], *(v[3:] for v in up), gpu.shape,
                                         tile0=3),
             lambda: kernels.tile_down_a(*d1, None, gpu.shape, False),
             lambda: kernels.tile_down_a(*d1, t["rout"], gpu.shape, True),
             lambda: kernels.tile_down_a(x, *(v[3:] for v in d1[1:]), t["rout"][3:],
                                         gpu.shape, True, tile0=3))
    for call in calls:
        a, b = call(), call()
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def _zeros(x, *shape):
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


# each tile wrapper on a plan's tables (t upward, d downward)
_WIDE = {
    "tile_pass_a": lambda x, t, d, p: kernels.tile_pass_a(x, t["rin"], t["ex_end"], p.shape),
    "tile_pass_c": lambda x, t, d, p: kernels.tile_pass_c(
        x, _zeros(x, p.NT, _T), _zeros(x, p.NT, p.E_pad), t["ent_idx"], t["near_end"],
        t["far_end"], t["rout"], p.shape),
    "tile_pass_c_full": lambda x, t, d, p: kernels.tile_pass_c(
        x, None, _zeros(x, p.NT, p.E_pad), t["ent_idx"], t["near_end"], t["far_end"],
        t["rout"], p.shape, rin=t["rin"]),
    "tile_down_a": lambda x, t, d, p: kernels.tile_down_a(
        x, t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"], t["rout"],
        p.shape, True),
    "tile_down_fin": lambda x, t, d, p: kernels.tile_down_fin(
        x, _zeros(x, p.NT, _T), _zeros(x, p.NT, p.R_pad), d["tree_of"], t["rout"], p.shape),
}


@pytest.mark.parametrize("call", list(_WIDE))
def test_tile_wrappers_take_int16_tables_only(tile_plans, call):
    """On the card the tile wrappers take the plan's int16 tables (n_tree
    int32) and raise TypeError on any other index dtype: no silent cast."""
    ids, gpu, _ = tile_plans
    gpu._ensure_down()
    x = torch.ones(ids.size, dtype=torch.int32, device="cuda")
    t, d = gpu.idx_t, gpu.down_idx_t
    _WIDE[call](x, t, d, gpu)  # the plan's own tables launch
    torch.cuda.synchronize()
    raised = set()
    for name in {**t, **d}:
        wrong = torch.int16 if name == "n_tree" else torch.int32
        wt = {k: v.to(wrong) if k == name else v for k, v in t.items()}
        wd = {k: v.to(wrong) if k == name else v for k, v in d.items()}
        try:
            _WIDE[call](x, wt, wd, gpu)
        except TypeError:
            raised.add(name)
    assert raised == _READS[call]


_READS = {"tile_pass_a": {"rin", "ex_end"},
          "tile_pass_c": {"ent_idx", "near_end", "far_end", "rout"},
          "tile_pass_c_full": {"rin", "ent_idx", "near_end", "far_end", "rout"},
          "tile_down_a": {"rin", "es", "g_last", "g_prev", "n_tree", "ent_slot", "rout"},
          "tile_down_fin": {"tree_of", "rout"}}


def _fill_inputs(shape, seed, dev):
    """A tilted noisy DEM with nodata cells, its fill seeds and an upper
    bound with finite values and +inf: one sweep's inputs on ``dev``."""
    from pyflwdir_torch.ops import fill as tfill

    rng = np.random.RandomState(seed)
    H, W = shape
    z = rng.rand(H, W) * 10 + np.add.outer(np.linspace(5, 0, H), np.linspace(5, 0, W))
    z[rng.rand(H, W) < 0.05] = -9999.0
    dem, seeds, bad = tfill.fill_setup(z, device=dev)
    up = np.where(rng.rand(H, W) < 0.3, np.inf, z + 3 * rng.rand(H, W)).astype(np.float32)
    w = torch.where(seeds, dem, torch.as_tensor(up, device=dev))
    w = torch.where(bad, float("inf"), w)
    return w, dem, (seeds | bad).to(torch.uint8)


@pytest.mark.parametrize("down", [True, False])
@pytest.mark.parametrize("conn8", [True, False])
@pytest.mark.parametrize("shape", [(301, 1000), (23, 9000)])
def test_fill_sweep(dev, shape, conn8, down):
    """F1 bitwise against its plain version on the same CUDA tensors, on a
    ragged shape and on rows wider than the kernel stages in shared memory
    (9,000 columns: b and the previous row then live in device memory)."""
    if shape[1] == 9000:
        assert shape[1] > kernels.load()["fill_kernels"].pf_fill_stage_cols()
    w, dem, fixed = _fill_inputs(shape, 9, dev)
    kernels.reset_launches()
    got = kernels.fill_sweep(w, dem, fixed, conn8, down)
    assert kernels.launches["fill_sweep"] == 1
    want = kernels.fill_sweep_plain(w, dem, fixed, conn8, down)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.launches["fill_sweep"] == 1  # the plain version never launches


def _fill_edge_inputs(nrow, ncol, dev, offset=0):
    """One sweep's inputs at ``nrow`` x ``ncol`` from numpy: nodata (+inf in d
    and w, fixed), seeds (fixed, w = d), an upper bound with +inf; past two
    rows, row 1 all fixed and row 2 all +inf in w. ``offset``: the three
    arrays as views that start ``offset`` elements into their storage."""
    rng = np.random.RandomState(nrow * 10_007 + ncol)
    d = (rng.rand(nrow, ncol) * 10).astype(np.float32)
    bad = rng.rand(nrow, ncol) < 0.05
    seed = rng.rand(nrow, ncol) < 0.1
    d[bad] = np.inf
    w = np.where(rng.rand(nrow, ncol) < 0.3, np.inf,
                 d + 3 * rng.rand(nrow, ncol)).astype(np.float32)
    fixed = bad | seed
    w[fixed] = d[fixed]
    if nrow > 2:
        fixed[1] = True
        w[1] = d[1]
        fixed[2] = False
        w[2] = np.inf

    def put(a, dtype):
        buf = torch.empty(a.size + offset, dtype=dtype, device=dev)
        t = buf[offset:].view(nrow, ncol)
        t.copy_(torch.as_tensor(a))
        return t

    return put(w, torch.float32), put(d, torch.float32), put(fixed.astype(np.uint8), torch.uint8)


@pytest.mark.parametrize("down", [True, False])
@pytest.mark.parametrize("conn8", [True, False])
@pytest.mark.parametrize("nrow", [1, 2, 5])
@pytest.mark.parametrize("ncol", [1, 2, 31, 33, 1023, 1025, 1536, 1537, 6000, 8192, 8193,
                                  9000])
def test_fill_sweep_edges(dev, ncol, nrow, conn8, down):
    """F1 bitwise against its plain version at the layout's edges: 256
    threads of K = 1 .. 6 columns up to 1,536, 512 threads of K = 4 .. 16 up
    to 8,192, the chunked path past that, rows whose floats (ncol % 4) or
    mask bytes (ncol % 16) are not 16-byte aligned, one and two rows, a row
    all fixed and a row all +inf."""
    w, dem, fixed = _fill_edge_inputs(nrow, ncol, dev)
    kernels.reset_launches()
    got = kernels.fill_sweep(w, dem, fixed, conn8, down)
    assert kernels.launches["fill_sweep"] == 1
    want = kernels.fill_sweep_plain(w, dem, fixed, conn8, down)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [1, 4])
@pytest.mark.parametrize("ncol", [32, 6000])
def test_fill_sweep_unaligned_views(dev, ncol, offset):
    """Arrays whose base is off 16 bytes (a storage offset of 1 or 4
    elements) take the kernel's loads for unaligned rows: the same bits."""
    w, dem, fixed = _fill_edge_inputs(6, ncol, dev, offset)
    assert w.data_ptr() % 16 != 0 or fixed.data_ptr() % 16 != 0
    for conn8 in (True, False):
        for down in (True, False):
            got = kernels.fill_sweep(w, dem, fixed, conn8, down)
            want = kernels.fill_sweep_plain(w, dem, fixed, conn8, down)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


def test_fill_and_d8_match_cpu(dev):
    """The device fill through F1 and d8_from_filled on the card bitwise
    equal to their CPU runs; two sweeps launched per round."""
    from pyflwdir_torch.ops import fill as tfill

    rng = np.random.RandomState(12)
    z = rng.rand(300, 400) + np.add.outer(np.linspace(2, 0, 300), np.linspace(2, 0, 400))
    z[100:120, 50:90] = -9999.0
    kernels.reset_launches()
    got = tfill.fill_depressions_dev(z, device=dev)
    assert kernels.launches["fill_sweep"] == 2 * tfill.last_rounds["fill"] > 0
    want = tfill.fill_depressions_dev(z, device="cpu")
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tfill.d8_from_filled(got).cpu(), tfill.d8_from_filled(want))


def test_strahler_tile_plan_and_float_sums(dev):
    """Strahler through a 300 x 260 tile plan (the router coarse level
    forced) on the card: the CPU plan's result and the native sweep's,
    with T1, T2 and the coarse H1-H3 once a level; then a float64
    ``graph.accumulate`` (the fixed-order scatter) twice with the same
    bits, and against the CPU within the stated rule."""
    from pyflwdir_torch import runtime
    from pyflwdir_torch.codecs import d8 as td8
    from pyflwdir_torch.ops import graph, order

    shape = (300, 260)
    ids = _demo_ids(shape, seed=9, missing=True)
    codes = td8.to_array(ids, shape)
    old = ttp._COARSE_ROUTER_MIN
    ttp._COARSE_ROUTER_MIN = 1
    try:
        gpu = ttp.build_tile_plan(ids, shape, device="cuda")
        cpu = ttp.build_tile_plan(ids, shape, device="cpu")
    finally:
        ttp._COARSE_ROUTER_MIN = old
    kernels.reset_launches()
    got = order.strahler_tile_plan(codes, gpu).cpu()
    levels = int(got.max()) - 1
    assert levels >= 3
    up = ("tile_pass_a", "accel_in_scan", "accel_near_out", "accel_far_merge", "tile_pass_c")
    assert all(kernels.launches[k] == (levels if k in up else 0) for k in kernels.launches), \
        kernels.launches
    assert torch.equal(got, order.strahler_tile_plan(codes, cpu))
    native = runtime.strahler_order(ids, runtime.dfs_preorder(ids)[0])
    assert np.array_equal(got.numpy().ravel(), native)

    x = torch.as_tensor(np.random.RandomState(3).rand(ids.size))
    d = torch.as_tensor(ids, device=dev)
    a = graph.accumulate(d, x.to(dev))
    b = graph.accumulate(d, x.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    want = graph.accumulate(torch.as_tensor(ids), x)
    nup = np.bincount(ids[(ids >= 0) & (ids != np.arange(ids.size))], minlength=ids.size)
    length = graph._n_rounds(ids.size) * int(nup.max())
    _assert_match(a.cpu(), want, float(x.sum()), length)


def test_object_surface_on_the_card(dev):
    """The object surface on a 300 x 260 raster on the card against the same
    raster on the CPU: windows, medians and averages bitwise (the average
    sums the window's rows in order), integer upstream sums bitwise and
    float64 ones twice with the same bits and within rtol 8 eps, the cell
    order, basin bounds and outlets bitwise; after ``add_pits`` the
    results of a fresh object."""
    import pyflwdir_torch
    from pyflwdir_torch.codecs import d8 as td8
    from pyflwdir_torch.ops import walk

    shape = (300, 260)
    codes = td8.to_array(_demo_ids(shape, seed=11, missing=True), shape)
    gpu = pyflwdir_torch.from_array(codes, device=dev)
    cpu = pyflwdir_torch.from_array(codes, device="cpu")
    rng = np.random.RandomState(5)
    data = (rng.rand(*shape) * 100).astype(np.float32)
    data[rng.rand(*shape) < 0.1] = -9999.0
    for restrict in (False, True):
        so = torch.as_tensor(cpu.stream_order().ravel()) if restrict else None
        win = walk.window_indices(gpu._ds, torch.as_tensor(gpu.idxs_us_main, device=dev), 5,
                                  None if so is None else so.to(dev))
        want = walk.window_indices(cpu._ds, torch.as_tensor(cpu.idxs_us_main), 5, so)
        assert torch.equal(win.cpu(), want)
        for fn in ("moving_median", "moving_average"):
            a = getattr(gpu, fn)(data, 5, restrict_strord=restrict)
            assert np.array_equal(a, getattr(cpu, fn)(data, 5, restrict_strord=restrict)), fn
    di = rng.randint(0, 100, shape).astype(np.int32)
    assert np.array_equal(gpu.upstream_sum(di), cpu.upstream_sum(di))
    df = rng.rand(*shape)
    a, b = gpu.upstream_sum(df), gpu.upstream_sum(df)
    assert np.array_equal(a.view(np.int64), b.view(np.int64))
    np.testing.assert_allclose(a, cpu.upstream_sum(df), rtol=8 * _EPS, atol=0)
    assert np.array_equal(gpu.idxs_seq, cpu.idxs_seq)
    bas = gpu.basins()
    for x, y in zip(gpu.basin_bounds(basins=bas) + gpu.basin_outlets(bas),
                    cpu.basin_bounds(basins=bas) + cpu.basin_outlets(bas)):
        assert np.array_equal(x, y)
    stream = gpu.upstream_area() >= 50
    idxs = rng.choice(np.flatnonzero(gpu.mask), 40, replace=False)
    gpu.add_pits(idxs=idxs, streams=stream)
    cpu.add_pits(idxs=idxs, streams=stream)
    fresh = pyflwdir_torch.FlwdirRaster(gpu.idxs_ds.copy(), shape, "d8", device=dev)
    assert np.array_equal(gpu.idxs_ds, cpu.idxs_ds)
    for name in ("upstream_area", "basins", "stream_order"):
        assert np.array_equal(getattr(gpu, name)(), getattr(fresh, name)()), name


def _framed_inputs(th, tw, dev, seed=0):
    """One sweep's inputs of a ``tiled_fill`` round on a (th + 2, tw + 2)
    frame: the block's DEM (nodata +inf and fixed, seeds fixed) and an
    upper bound; the border rows and columns fixed and holding a neighbour's
    surface (finite values and +inf) in both the frame and the DEM."""
    rng = np.random.RandomState(seed * 7_919 + th * 10_007 + tw)
    H, W = th + 2, tw + 2
    d = (rng.rand(H, W) * 10).astype(np.float32)
    bad = rng.rand(H, W) < 0.05
    seed_ = rng.rand(H, W) < 0.05
    d[bad] = np.inf
    w = np.where(rng.rand(H, W) < 0.3, np.inf, d + 3 * rng.rand(H, W)).astype(np.float32)
    fixed = bad | seed_
    w[fixed] = d[fixed]
    border = np.ones((H, W), bool)
    border[1:-1, 1:-1] = False
    surface = np.where(rng.rand(H, W) < 0.2, np.inf, rng.rand(H, W) * 12).astype(np.float32)
    w[border] = d[border] = surface[border]
    fixed |= border
    return (torch.as_tensor(w, device=dev), torch.as_tensor(d, device=dev),
            torch.as_tensor(fixed.astype(np.uint8), device=dev))


@pytest.mark.parametrize("down", [True, False])
@pytest.mark.parametrize("conn8", [True, False])
@pytest.mark.parametrize("th,tw", [(1, 1), (1, 2), (3, 3), (5, 31), (4, 1023), (6, 1534),
                                   (3, 4094), (4, 6000), (200, 130)])
def test_fill_sweep_framed(dev, th, tw, conn8, down):
    """F1 on the framed buffers of ``tiled_fill`` (widths 3 to 6,002: its
    layouts of 256 and 512 threads, rows not 16-byte aligned), bitwise
    against its plain version, the border kept; and on the frame as
    ``tiled_fill`` lays it out, rows padded with fixed +inf columns to a
    multiple of 16: the same values in the frame's columns."""
    w, d, fixed = _framed_inputs(th, tw, dev)
    kernels.reset_launches()
    got = kernels.fill_sweep(w, d, fixed, conn8, down)
    assert kernels.launches["fill_sweep"] == 1
    want = kernels.fill_sweep_plain(w, d, fixed, conn8, down)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[0], w[0]) and torch.equal(got[:, -1], w[:, -1])
    extra = -(-(tw + 2) // 16) * 16 - tw - 2
    pad = torch.nn.functional.pad
    wa, da = (pad(t, (0, extra), value=float("inf")) for t in (w, d))
    fa = pad(fixed, (0, extra), value=1)
    aligned = kernels.fill_sweep(wa, da, fa, conn8, down)
    torch.cuda.synchronize()
    assert torch.equal(aligned[:, : tw + 2], got)
    assert torch.equal(aligned, kernels.fill_sweep_plain(wa, da, fa, conn8, down))


def test_halo_functions_on_one_card(dev):
    """The ``tiled_*`` functions on a one-rank mesh of this process (no
    group) on the card against the port's single-device functions: integer
    results and the fill bitwise, unit sums bitwise, F1 launched by the
    fill and no plain sweep run on the card."""
    from pyflwdir_torch import dem, parallel, streams
    from pyflwdir_torch.codecs import d8 as d8c
    from pyflwdir_torch.ops import fill as tfill
    from pyflwdir_torch.ops import graph
    from pyflwdir_torch.ops import order as tord

    rng = np.random.RandomState(3)
    z = rng.rand(300, 400) + np.add.outer(np.linspace(2, 0, 300), np.linspace(2, 0, 400))
    z[100:120, 150:180] -= 1.5
    z[5:8, 9:11] = -9999.0
    filled, d8 = dem.fill_depressions(z, nodata=-9999.0)
    mesh = parallel.make_mesh()
    assert mesh.device.type == "cuda"
    ids, pits, _ = d8c.from_array(d8, dtype=np.int64)
    ids_t = torch.as_tensor(ids, device=dev)
    valid = (ids >= 0).reshape(d8.shape)
    unit = graph.accumulate(ids_t, torch.ones(ids.size, dtype=torch.int32, device=dev))
    for method in ("coarse", "iterate"):
        got = parallel.tiled_accumulate(d8, np.ones(d8.shape), mesh, method=method)
        assert np.array_equal(got[valid], unit.cpu().numpy().reshape(d8.shape)[valid]
                              .astype(np.float32))
    assert np.array_equal(parallel.tiled_rank(d8, mesh).ravel(), graph.rank(ids_t).cpu().numpy())
    from pyflwdir_torch import basins

    assert np.array_equal(parallel.tiled_basins(d8, pits, mesh).ravel(),
                          basins.basins(ids_t, pits).ravel())
    want = streams.stream_distance(ids_t, d8.shape, real_length=False).cpu().numpy()
    got = parallel.tiled_stream_distance(d8, mesh, real_length=False)
    assert np.array_equal(got[valid], want.reshape(d8.shape)[valid])
    sto = tord.strahler_order(ids_t).cpu().numpy().reshape(d8.shape)
    assert np.array_equal(parallel.tiled_strahler(d8, mesh)[valid], sto[valid])
    kernels.reset_launches()
    got = parallel.tiled_fill(z, mesh, nodata=-9999.0)
    assert kernels.launches["fill_sweep"] == 2 * parallel.tiled.last_rounds["fill"] > 0
    want = tfill.fill_depressions_dev(z, nodata=-9999.0, device=dev).cpu().numpy()
    assert np.array_equal(got.astype(np.float32), want)
    assert np.allclose(got, filled)


# ---------------------------------------------------------------------------
# tiles of 256, 384 and 512 rows: T1-T4 as thread-block clusters of G CTAs
# ---------------------------------------------------------------------------
_TALL_SHAPE = (700, 400)  # 3 x 4, 2 x 4 and 2 x 4 tiles, ragged in both directions


@pytest.fixture(scope="module", params=[256, 384, 512])
def tall_plans(request):
    """A 700 x 400 plan of ``tile_rows`` 256, 384 or 512 on the card (its
    tables int16 at 256 rows, int32 above) and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    Y = request.param
    ids = _demo_ids(_TALL_SHAPE, seed=17, missing=True)
    gpu = ttp.build_tile_plan(ids, _TALL_SHAPE, tile_rows=Y, device="cuda")
    cpu = ttp.build_tile_plan(ids, _TALL_SHAPE, tile_rows=Y, device="cpu")
    gpu._ensure_down()
    assert gpu.has_entries and gpu.has_far
    return ids, gpu, cpu


def _g(name, gpu):
    return f"{name}_g{gpu.G}"


def _only(**want):
    """Every launch count is ``want``'s (0 where not named)."""
    assert all(kernels.launches[k] == want.get(k, 0) for k in kernels.launches), \
        {k: v for k, v in kernels.launches.items() if v}


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tall_tile_pass_a_and_c(tall_plans, dtype):
    """T1 (fused and exits only) and T2 (fused and full) against their plain
    versions; the cluster kernels counted apart; the fused pair and the
    unfused pair give the same bits."""
    ids, gpu, _ = tall_plans
    t = gpu.idx_t
    assert t["rin"].dtype == kernels.tile_table_dtype(gpu.Y)
    rng = np.random.RandomState(31)
    x = _data(rng, ids.size, dtype).to("cuda")
    entv = _data(rng, gpu.NT * gpu.E_pad, dtype).to("cuda").reshape(gpu.NT, gpu.E_pad)
    total = float(x.double().sum()) + float(entv.double().sum())
    kernels.reset_launches()
    exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], gpu.shape)
    ex_only = kernels.tile_pass_a(x, t["rin"], t["ex_end"], gpu.shape, emit_c=False)
    _only(**{_g("tile_pass_a", gpu): 1, _g("tile_pass_a_exits", gpu): 1})
    ex_p, c_p = kernels.tile_pass_a_plain(x, t["rin"], t["ex_end"], gpu.shape)
    _assert_match(c, c_p, total)
    _assert_match(exits, ex_p, total)
    assert torch.equal(exits, ex_only)
    up = (entv, t["ent_idx"], t["near_end"], t["far_end"], t["rout"], gpu.shape)
    kernels.reset_launches()
    got = kernels.tile_pass_c(x, c, *up)
    full = kernels.tile_pass_c(x, None, *up, rin=t["rin"])
    _only(**{_g("tile_pass_c", gpu): 1, _g("tile_pass_c_full", gpu): 1})
    _assert_match(got, kernels.tile_pass_c_plain(x, c, *up), total)
    assert torch.equal(got, full)


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tall_tile_down(tall_plans, dtype, routed):
    """T3 (raw and routed) and T4 (fin and lite) against their plain
    versions; lite bitwise fin on the raw pass D1."""
    ids, gpu, _ = tall_plans
    t, d = gpu.idx_t, gpu.down_idx_t
    rng = np.random.RandomState(32)
    x = _data(rng, ids.size, dtype).to("cuda")
    A = _data(rng, gpu.NT * gpu.R_pad, dtype).to("cuda").reshape(gpu.NT, gpu.R_pad)
    d1 = (x, t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
    args = (*d1, t["rout"] if routed else None, gpu.shape, routed)
    kernels.reset_launches()
    z, pk = kernels.tile_down_a(*args)
    _only(**{_g("tile_down_a", gpu): 1})
    z_p, pk_p = kernels.tile_down_a_plain(*args)
    total = float(x.double().sum())
    _assert_match(z, z_p, total)
    _assert_match(pk, pk_p, total)
    z2, pk2 = kernels.tile_down_a(*args)
    assert torch.equal(z, z2) and torch.equal(pk, pk2)
    if routed:
        lite_args = (z, A, d["tree_of"], t["rout"], gpu.shape)
        kernels.reset_launches()
        got = kernels.tile_down_lite(*lite_args)
        _only(**{_g("tile_down_lite", gpu): 1})
        assert torch.equal(got, kernels.tile_down_lite_plain(*lite_args))
        z1, _ = kernels.tile_down_a(*d1, None, gpu.shape, False)
        assert torch.equal(got, kernels.tile_down_fin(x, z1, A, d["tree_of"], t["rout"],
                                                      gpu.shape))
    else:
        fin_args = (x, z, A, d["tree_of"], t["rout"], gpu.shape)
        kernels.reset_launches()
        got = kernels.tile_down_fin(*fin_args)
        _only(**{_g("tile_down_fin", gpu): 1})
        assert torch.equal(got, kernels.tile_down_fin_plain(*fin_args))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_tall_tile_ranges(tall_plans, dtype):
    """The tile-range forms of T1, T2, T3 (routed) and T4 (lite and fin) on
    ranges that start and end in the middle of a tile row: bitwise the same
    tiles of the whole-grid call, and their plain versions."""
    ids, gpu, _ = tall_plans
    t, d = gpu.idx_t, gpu.down_idx_t
    shape = gpu.shape
    rng = np.random.RandomState(33)
    x = _data(rng, ids.size, dtype).to("cuda")
    entv = _data(rng, gpu.NT * gpu.E_pad, dtype).to("cuda").reshape(gpu.NT, gpu.E_pad)
    A = _data(rng, gpu.NT * gpu.R_pad, dtype).to("cuda").reshape(gpu.NT, gpu.R_pad)
    total = float(x.double().sum()) + float(entv.double().sum())
    T = gpu.Y * 128
    exits, c = kernels.tile_pass_a(x, t["rin"], t["ex_end"], shape)
    up = (t["ent_idx"], t["near_end"], t["far_end"], t["rout"])
    out = kernels._tiles(kernels.tile_pass_c(x, c, entv, *up, shape), shape, T)
    d1 = (t["rin"], d["es"], d["g_last"], d["g_prev"], d["n_tree"], d["ent_slot"])
    z1, _ = kernels.tile_down_a(x, *d1, None, shape, False)
    abar, pk = kernels.tile_down_a(x, *d1, t["rout"], shape, True)
    lite = kernels.tile_down_lite(abar, A, d["tree_of"], t["rout"], shape)
    abar, lite = kernels._tiles(abar, shape, T), kernels._tiles(lite, shape, T)
    for lo, hi in ((1, gpu.NT - 2), (gpu.grid[1] + 1, gpu.NT)):
        s = slice(lo, hi)
        kernels.reset_launches()
        ex_r, c_r = kernels.tile_pass_a(x, t["rin"][s], t["ex_end"][s], shape, tile0=lo)
        assert torch.equal(ex_r, exits[s]) and torch.equal(c_r, c[s])
        got = kernels.tile_pass_c(x, c_r, entv[s], *(v[s] for v in up), shape, tile0=lo)
        assert got.shape == (hi - lo, T) and torch.equal(got, out[s])
        _assert_match(got, kernels.tile_pass_c_plain(x, c_r, entv[s], *(v[s] for v in up),
                                                     shape, tile0=lo), total)
        ab_r, pk_r = kernels.tile_down_a(x, *(v[s] for v in d1), t["rout"][s], shape, True,
                                         tile0=lo)
        assert torch.equal(ab_r, abar[s]) and torch.equal(pk_r, pk[s])
        lite_args = (ab_r, A[s], d["tree_of"][s], t["rout"][s], shape)
        got = kernels.tile_down_lite(*lite_args, tile0=lo)
        _only(**{_g(k, gpu): 1 for k in ("tile_pass_a", "tile_pass_c", "tile_down_a",
                                          "tile_down_lite")})
        assert torch.equal(got, lite[s])
        assert torch.equal(got, kernels.tile_down_lite_plain(*lite_args, tile0=lo))
        assert torch.equal(got, kernels.tile_down_fin(x, z1[s], A[s], d["tree_of"][s],
                                                      t["rout"][s], shape, tile0=lo))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_tall_plan_matches_cpu(tall_plans, dtype):
    """``accumulate``, ``accumulate_down`` and the banded sweep of the tall
    plan on the card against the CPU plan: the cluster kernels ran and no
    128-row one; two float64 calls give the same bits."""
    ids, gpu, cpu = tall_plans
    x = _data(np.random.RandomState(34), ids.size, dtype)
    xd = x.to("cuda")
    total = float(x.double().sum())
    kernels.reset_launches()
    got = gpu.accumulate(xd)
    assert kernels.launches[_g("tile_pass_a", gpu)] == kernels.launches[
        _g("tile_pass_c", gpu)] == 1
    assert not any(kernels.launches[k] for k in kernels._TILE_COUNTS)
    assert torch.equal(got, gpu.accumulate(xd))
    _assert_match(got.cpu(), cpu.accumulate(x), total)
    kernels.reset_launches()
    down = gpu.accumulate_down(xd)
    assert kernels.launches[_g("tile_down_a", gpu)] == 1
    assert not any(kernels.launches[k] for k in kernels._TILE_COUNTS)
    assert torch.equal(down, gpu.accumulate_down(xd))
    _assert_match(down.cpu(), cpu.accumulate_down(x), total)
    fresh = ttp.build_tile_plan(ids, _TALL_SHAPE, tile_rows=gpu.Y, device="cuda")
    x2 = x.numpy().reshape(_TALL_SHAPE)
    kernels.reset_launches()
    band = fresh.accumulate_banded(x2, band_tile_rows=1)
    assert kernels.launches[_g("tile_pass_a_exits", gpu)] == gpu.grid[0]
    assert kernels.launches[_g("tile_pass_c_full", gpu)] == gpu.grid[0]
    assert not any(kernels.launches[k] for k in kernels._TILE_COUNTS)
    assert np.array_equal(band.ravel(), got.cpu().numpy())


def test_tall_wrappers_take_their_table_type_only(tall_plans):
    """At 256 rows the cluster kernels take int16 tables, above int32; a
    table of the other type raises TypeError, and 128-row tables of int32
    still do."""
    ids, gpu, _ = tall_plans
    t = gpu.idx_t
    x = torch.ones(ids.size, dtype=torch.int32, device="cuda")
    other = torch.int32 if gpu.Y == 256 else torch.int16
    with pytest.raises(TypeError):
        kernels.tile_pass_a(x, t["rin"].to(other), t["ex_end"], gpu.shape)
    with pytest.raises(ValueError):  # a row of 3 * 16,384 + 1 slots is no tile height
        kernels.tile_pass_a(x, torch.zeros((gpu.NT, 3 * 16384 + 2), dtype=torch.int32,
                                           device="cuda"), t["ex_end"], gpu.shape)
    # T4 takes the plan's tree table in tile_tree_dtype only (int16 here)
    tree = gpu.down_idx_t["tree_of"]
    assert tree.dtype == kernels.tile_tree_dtype(gpu.Y, gpu.R_pad) == torch.int16
    z1 = torch.zeros(t["rout"].shape, dtype=torch.int32, device="cuda")
    A = torch.zeros((gpu.NT, gpu.R_pad), dtype=torch.int32, device="cuda")
    kernels.tile_down_fin(x, z1, A, tree, t["rout"], gpu.shape)
    torch.cuda.synchronize()
    with pytest.raises(TypeError):
        kernels.tile_down_fin(x, z1, A, tree.to(torch.int32), t["rout"], gpu.shape)
    with pytest.raises(TypeError):
        kernels.tile_down_lite(x, A, tree, t["rout"].to(other), gpu.shape)


def _tall_edge_tables(Y, E, seed, dev):
    """Synthetic tables of every tile kernel for the tiles of ``_EDGE_SHAPE``
    at ``Y`` rows (T = 128 Y slots a tile; int16 at 256 rows, int32 above):
    rin and es random permutations of a tile, so that about (G - 1) / G of
    every gather reads a peer CTA's shared memory; the other slot tables -1
    or a random slot, ent_idx -1 or an entry rank below E; n_tree 0 in the
    first tile, T in the second (entry ranks below 2^15 in int16 tables)."""
    H, W = _EDGE_SHAPE
    T = Y * 128
    ntx = -(-W // 128)
    NT = -(-H // Y) * ntx
    rng = np.random.RandomState(seed)

    def perm():
        return np.stack([rng.permutation(T) for _ in range(NT)])

    def idx(hi, shape=(NT, T), p_neg=0.3):
        a = rng.randint(0, max(hi, 1), shape)
        return np.where((rng.rand(*shape) < p_neg) | (hi == 0), -1, a)

    l = np.arange(T)
    t = np.arange(NT)[:, None]
    past = ((t // ntx) * Y + l // 128 >= H) | ((t % ntx) * 128 + l % 128 >= W)
    tabs = dict(rin=perm(), es=perm(), rout=np.where(past, -1, idx(T)), near_end=idx(T),
                far_end=idx(T, p_neg=0.8), ent_idx=idx(min(E, 1 << 15) if Y == 256 else E),
                g_last=idx(T), g_prev=idx(T), ent_slot=idx(T, (NT, E), 0.2),
                ex_end=idx(T, (NT, 128), 0),
                tree_of=idx(300))
    dt = kernels.tile_table_dtype(Y)
    tabs = {k: torch.as_tensor(v, device=dev).to(dt) for k, v in tabs.items()}
    n_tree = rng.randint(0, T + 1, NT)
    n_tree[:2] = 0, T
    tabs["n_tree"] = torch.as_tensor(n_tree.astype(np.int32), device=dev)
    return tabs


def _max_entries(Y, dtype):
    """The most entries a tile of the cluster kernels' T2 takes (each CTA
    scans all of them beside its 16,384-slot chunk)."""
    esize = torch.empty((), dtype=dtype).element_size()
    lib = kernels.load()[kernels._TILE_LIB[Y // 128]]
    return lib.pf_tile_max_smem() // esize - 128 * 128


@pytest.mark.parametrize("E", [0, 300, "max"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
@pytest.mark.parametrize("Y", [256, 384, 512])
def test_tall_remote_gathers(dev, Y, dtype, E):
    """Every T2 and T3 form of the cluster kernels on random tables, whose
    gathers lie mostly in a peer CTA's chunk, with no entries, some, and the
    most T2's shared memory takes (one more raises): bitwise the plain
    versions (integer-valued data, exact in every order), whole grid and on
    a tile range; T3 twice the same bits."""
    E = _max_entries(Y, dtype) if E == "max" else E
    t = _tall_edge_tables(Y, E, 41, dev)
    H, W = shape = _EDGE_SHAPE
    rng = np.random.RandomState(42)
    NT, T = t["rin"].shape
    x = _edge_data(rng, H * W, dtype, dev)
    c = _edge_data(rng, NT * T, dtype, dev).reshape(NT, T)
    entv = _edge_data(rng, NT * E, dtype, dev).reshape(NT, E)
    up = (t["ent_idx"], t["near_end"], t["far_end"], t["rout"])
    G = Y // 128
    kernels.reset_launches()
    fused = kernels.tile_pass_c(x, c, entv, *up, shape)
    full = kernels.tile_pass_c(x, None, entv, *up, shape, rin=t["rin"])
    assert kernels.launches[f"tile_pass_c_g{G}"] == kernels.launches[f"tile_pass_c_full_g{G}"] == 1
    torch.cuda.synchronize()
    assert torch.equal(fused, kernels.tile_pass_c_plain(x, c, entv, *up, shape))
    assert torch.equal(full, kernels.tile_pass_c_plain(x, None, entv, *up, shape, rin=t["rin"]))
    lo, hi = 1, NT - 1
    s = slice(lo, hi)
    got = kernels.tile_pass_c(x, c[s], entv[s], *(v[s] for v in up), shape, tile0=lo)
    assert torch.equal(got, kernels._tiles(fused, shape, T)[s])
    d1 = (x, t["rin"], t["es"], t["g_last"], t["g_prev"], t["n_tree"], t["ent_slot"])
    for routed in (False, True):
        args = (*d1, t["rout"] if routed else None, shape, routed)
        got = kernels.tile_down_a(*args)
        for g, w in zip(got, kernels.tile_down_a_plain(*args)):
            assert torch.equal(g, w)
        again = kernels.tile_down_a(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    args = (x, *(v[s] for v in d1[1:]), t["rout"][s], shape, True)
    for g, w in zip(kernels.tile_down_a(*args, tile0=lo),
                    kernels.tile_down_a_plain(*args, tile0=lo)):
        assert torch.equal(g, w)
    if E and E == _max_entries(Y, dtype):
        entv = _edge_data(rng, NT * (E + 1), dtype, dev).reshape(NT, E + 1)
        with pytest.raises(ValueError, match="shared"):
            kernels.tile_pass_c(x, c, entv, *up, shape)


@pytest.mark.parametrize("Y", [256, 384, 512])
def test_tall_float64_down_same_bits(dev, Y):
    """T3 raw and routed in float64 on random (non-integer) data and the
    random tables: two calls give the same bits, within the rule of the
    plain version."""
    t = _tall_edge_tables(Y, 300, 43, dev)
    H, W = shape = _EDGE_SHAPE
    x = torch.as_tensor(np.random.RandomState(44).rand(H * W), device=dev)
    d1 = (x, t["rin"], t["es"], t["g_last"], t["g_prev"], t["n_tree"], t["ent_slot"])
    for routed in (False, True):
        args = (*d1, t["rout"] if routed else None, shape, routed)
        a, b = kernels.tile_down_a(*args), kernels.tile_down_a(*args)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        for g, w in zip(a, kernels.tile_down_a_plain(*args)):
            _assert_match(g, w, float(x.sum()), length=2 * Y * 128)


def _tall_exit_ends(Y, NT, R, rng, dev):
    """Random exit ends of R exits a tile, most in a peer CTA's chunk: tile
    0 a padded row (every end the tile's last slot), tile 1 sorted."""
    T = Y * 128
    ex = rng.randint(0, T, (NT, R))
    ex[0] = T - 1
    ex[1] = np.sort(ex[1])
    return torch.as_tensor(ex, device=dev).to(kernels.tile_table_dtype(Y))


def _tall_tree(t, R, rng, dev, Y):
    """A random raster-layout tree table of R trees: -1 off the tree (rout
    -1) and on a tenth of the tree cells, in tile_tree_dtype."""
    NT, T = t["rout"].shape
    tr = np.where(rng.rand(NT, T) < 0.1, -1, rng.randint(0, R, (NT, T)))
    tree = torch.where(t["rout"] >= 0, torch.as_tensor(tr, device=dev), -1)
    return tree.to(kernels.tile_tree_dtype(Y, R))


@pytest.mark.parametrize("R", [384, 40000])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
@pytest.mark.parametrize("Y", [256, 384, 512])
def test_tall_t1_t4_remote_tables(dev, Y, dtype, R):
    """T1 (fused, exits only, tile range) and T4 (fin, lite, tile range) on
    random tables whose gathers mostly lie in a peer CTA's chunk, R exits
    and trees a tile (40,000: an int32 tree table, from 384 rows), a padded
    exit row among them: bitwise their plain versions (integer-valued
    data); T1 launched as a cluster of G CTAs, T4 as a plain grid."""
    if Y == 256 and R > 1 << 15:
        pytest.skip("a 256-row tile has at most 32,768 roots")
    t = _tall_edge_tables(Y, 0, 45, dev)
    H, W = shape = _EDGE_SHAPE
    NT, T = t["rin"].shape
    G = Y // 128
    rng = np.random.RandomState(46)
    x = _edge_data(rng, H * W, dtype, dev)
    kernels.reset_launches()
    if R <= T:
        ex_end = _tall_exit_ends(Y, NT, R, rng, dev)
        exits, c = kernels.tile_pass_a(x, t["rin"], ex_end, shape)
        assert kernels.tile_last_cluster(Y) == G
        ex_only = kernels.tile_pass_a(x, t["rin"], ex_end, shape, emit_c=False)
        ex_p, c_p = kernels.tile_pass_a_plain(x, t["rin"], ex_end, shape)
        torch.cuda.synchronize()
        assert torch.equal(exits, ex_p) and torch.equal(c, c_p) and torch.equal(ex_only, ex_p)
        s = slice(1, NT - 1)
        ex_r, c_r = kernels.tile_pass_a(x, t["rin"][s], ex_end[s], shape, tile0=1)
        assert torch.equal(ex_r, exits[s]) and torch.equal(c_r, c[s])
        assert kernels.launches[f"tile_pass_a_g{G}"] == 2
        assert kernels.launches[f"tile_pass_a_exits_g{G}"] == 1
    tree = _tall_tree(t, R, rng, dev, Y)
    assert tree.dtype == (torch.int16 if R < 1 << 15 else torch.int32)
    A = _edge_data(rng, NT * R, dtype, dev).reshape(NT, R)
    z1 = _edge_data(rng, NT * T, dtype, dev).reshape(NT, T)
    abar = _edge_data(rng, H * W, dtype, dev)
    fin_args = (x, z1, A, tree, t["rout"], shape)
    fin = kernels.tile_down_fin(*fin_args)
    assert kernels.tile_last_cluster(Y) == 1
    lite = kernels.tile_down_lite(abar, A, tree, t["rout"], shape)
    assert kernels.tile_last_cluster(Y) == 1
    assert torch.equal(fin, kernels.tile_down_fin_plain(*fin_args))
    assert torch.equal(lite, kernels.tile_down_lite_plain(abar, A, tree, t["rout"], shape))
    s = slice(1, NT - 1)
    abar_t = kernels._tiles(abar, shape, T)
    l_args = (abar_t[s], A[s], tree[s], t["rout"][s], shape)
    got = kernels.tile_down_lite(*l_args, tile0=1)
    assert torch.equal(got, kernels._tiles(lite, shape, T)[s])
    assert torch.equal(got, kernels.tile_down_lite_plain(*l_args, tile0=1))
    got = kernels.tile_down_fin(x, z1[s], A[s], tree[s], t["rout"][s], shape, tile0=1)
    assert torch.equal(got, kernels._tiles(fin, shape, T)[s])
    assert kernels.launches[f"tile_down_fin_g{G}"] == kernels.launches[
        f"tile_down_lite_g{G}"] == 2


@pytest.mark.parametrize("Y", [256, 384, 512])
def test_tall_float64_t1_t4_same_bits(dev, Y):
    """T1 and T4 in float64 on random (non-integer) data and the random
    tables: two calls give the same bits; T1 within the rule of its plain
    version (a tile's T slots), T4 (one addition a cell) bitwise."""
    t = _tall_edge_tables(Y, 0, 47, dev)
    H, W = shape = _EDGE_SHAPE
    NT, T = t["rin"].shape
    rng = np.random.RandomState(48)
    x = torch.as_tensor(rng.rand(H * W), device=dev)
    ex_end = _tall_exit_ends(Y, NT, 384, rng, dev)
    fused = [kernels.tile_pass_a(x, t["rin"], ex_end, shape) for _ in range(2)]
    only = [kernels.tile_pass_a(x, t["rin"], ex_end, shape, emit_c=False) for _ in range(2)]
    assert all(torch.equal(u, v) for u, v in zip(*fused))
    assert torch.equal(*only) and torch.equal(only[0], fused[0][0])
    for g, w in zip(fused[0], kernels.tile_pass_a_plain(x, t["rin"], ex_end, shape)):
        _assert_match(g, w, float(x.sum()), length=T)
    tree = _tall_tree(t, 384, rng, dev, Y)
    A = torch.as_tensor(rng.rand(NT, 384), device=dev)
    z1 = torch.as_tensor(rng.rand(NT, T), device=dev)
    fin_args = (x, z1, A, tree, t["rout"], shape)
    fin = kernels.tile_down_fin(*fin_args)
    assert torch.equal(fin, kernels.tile_down_fin(*fin_args))
    assert torch.equal(fin, kernels.tile_down_fin_plain(*fin_args))
    lite = kernels.tile_down_lite(x, A, tree, t["rout"], shape)
    assert torch.equal(lite, kernels.tile_down_lite_plain(x, A, tree, t["rout"], shape))


# ---------------------------------------------------------------------------
# int32 sums that wrap: integer data of up to 32 bits sums in int32 whatever
# its range, so every int32 add and subtraction of the kernels must wrap
# modulo 2^32 and give the low bits of the int64 sums
# ---------------------------------------------------------------------------
def _wrapping(n, seed):
    """int32 data over the whole int32 range: sums of a few values pass
    +-2^31 and wrap."""
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randint(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32))


def _assert_wraps_like_int64(call, x):
    """``call`` on int32 ``x`` gives the bits of ``call`` on ``x`` as int64
    cast back to int32, and the int64 sums pass +-2^31 (the int32 ones
    wrapped). Returns the int32 result."""
    got = call(x)
    wide = call(x.to(torch.int64))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and wide.dtype == torch.int64
    assert int(wide.abs().max()) >= 1 << 31
    assert torch.equal(got, wide.to(torch.int32))
    return got


def _assert_plan_wraps(gpu, cpu, ids, seed):
    """Upward and downward sweeps of a tile plan, and its coarse level
    upward and downward in slot mode, on wrapping int32 data: the int64
    path's bits, and the CPU plan's."""
    x = _wrapping(ids.size, seed)
    xd = x.to("cuda")
    up = _assert_wraps_like_int64(gpu.accumulate, xd)
    assert torch.equal(up.cpu(), cpu.accumulate(x))
    down = _assert_wraps_like_int64(gpu.accumulate_down, xd)
    assert torch.equal(down.cpu(), cpu.accumulate_down(x))
    c = gpu.coarse
    _assert_wraps_like_int64(c.accumulate, _wrapping(c.n_in, seed + 1).to("cuda"))
    _assert_wraps_like_int64(c.accumulate_down, _wrapping(c.n_out, seed + 2).to("cuda"))
    return x, up


@pytest.mark.parametrize("coarse", ["router", "gather"])
def test_int32_sums_wrap_on_128_row_plans(tile_plans, odd_plans, coarse):
    """T1, T2, T3 and T4 at 128 rows with the router coarse level (H1-H3
    upward, H1 and H0 downward) or the gather one, and the banded sweep (T1
    exits only, T2 full), on int32 data whose sums wrap."""
    ids, gpu, cpu = tile_plans if coarse == "router" else odd_plans
    x, up = _assert_plan_wraps(gpu, cpu, ids, 41)
    fresh = ttp.build_tile_plan(ids, gpu.shape, device="cuda")
    band = fresh.accumulate_banded(x.numpy().reshape(gpu.shape), band_tile_rows=1)
    assert band.dtype == np.int32 and np.array_equal(band.ravel(), up.cpu().numpy())


def test_int32_sums_wrap_on_tall_plans(tall_plans):
    """The cluster kernels of 256-, 384- and 512-row plans and their coarse
    level on int32 data whose sums wrap."""
    ids, gpu, cpu = tall_plans
    _assert_plan_wraps(gpu, cpu, ids, 43)


def test_int32_sums_wrap_on_big_accel_plan_at_two_chunks(dev):
    """H1, H2 and H3 of a BigAccelPlan at 2^22 slots on int32 data whose sums
    wrap."""
    from pyflwdir_torch.ops import accel_big as tbig
    from pyflwdir_torch.ops import plan as tplan

    ids = _demo_ids((1504, 1504), seed=17, missing=True)
    gpu = taccel.build_accel_plan(ids, device=dev)
    assert isinstance(gpu, tbig.BigAccelPlan) and gpu.n_pad == 1 << 22
    x = _wrapping(ids.size, 47)
    got = _assert_wraps_like_int64(gpu.accumulate, x.to(dev))
    # the int64 DFS plan on the CPU, cast back
    assert torch.equal(got.cpu(), tplan.accumulate_planned(tplan.build_plan(ids, device="cpu"), x))
