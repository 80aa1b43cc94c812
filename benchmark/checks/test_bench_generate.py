"""The seeded generators: deterministic per seed, acyclic, outlets only on
the lower and right edges, and the reach network of hydrorivers."""

import math

import pytest
import torch

from benchmark import generate, manifest, reference

CPU = torch.device("cpu")
CFG = manifest.config(manifest.load(), "merit3s-tile")
RIVERS = manifest.config(manifest.load(), "hydrorivers")
CHOICES = CFG["d8"]["choices"]


def test_d8_same_seed_same_raster_and_large_seeds():
    a = generate.scheidegger_d8((60, 70), CHOICES, 2**31 + 11, CPU)
    b = generate.scheidegger_d8((60, 70), CHOICES, 2**31 + 11, CPU)
    c = generate.scheidegger_d8((60, 70), CHOICES, 2**31 + 12, CPU)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_d8_acyclic_outlets_on_lower_and_right_edges(seed):
    H, W = 50, 80
    codes, ds = generate.scheidegger_d8((H, W), CHOICES, seed, CPU)
    assert set(codes.unique().tolist()) <= {1, 2, 4}
    ar = torch.arange(H * W)
    pit = ds == ar
    r, c = ar // W, ar % W
    assert bool(((r == H - 1) | (c == W - 1))[pit].all())
    step = torch.stack([ds // W - r, ds % W - c], 1)[~pit]
    assert bool(((step >= 0).all(1) & (step.sum(1) > 0)).all())  # down or right only
    reference.depths(ds)  # raises on a cycle


def test_d8_codes_point_where_ds_points():
    H, W = 30, 40
    codes, ds = generate.scheidegger_d8((H, W), CHOICES, 3, CPU)
    inv = {v: k for k, v in generate.D8_CODE.items()}
    for i in torch.randint(0, H * W, (200,), generator=torch.Generator().manual_seed(0)):
        i = int(i)
        dr, dc = inv[int(codes.reshape(-1)[i])]
        r, c = divmod(i, W)
        want = (r + dr) * W + c + dc if r + dr < H and c + dc < W else i
        assert int(ds[i]) == want


def test_reaches_of_a_hand_made_network():
    # 0 -> 2, 1 -> 2, 2 -> 3, 3 -> 4 (pit), 5 -> 4
    ds = torch.tensor([2, 2, 3, 4, 4, 4])
    reach_ds, heads = generate.contract_reaches(ds)
    # starts: 0, 1 (headwaters), 2 (confluence of 0 and 1), 4 (confluence of 3 and 5), 5
    assert heads.tolist() == [0, 1, 2, 4, 5]
    assert reach_ds.tolist() == [2, 2, 3, 3, 3]


def test_reach_in_degrees_and_count():
    codes, ds = generate.scheidegger_d8((300, 300), CHOICES, 7, CPU)
    reach_ds, heads = generate.contract_reaches(ds)
    k = torch.arange(reach_ds.numel())
    indeg = generate.indegree(reach_ds)
    outlet = reach_ds == k
    # every reach starts at a headwater or at a confluence of two or three
    assert set(indeg.unique().tolist()) <= {0, 2, 3}
    assert bool((heads[outlet] // 300 == 299).logical_or(heads[outlet] % 300 == 299).sum() >= 0)
    reference.depths(reach_ds)
    share = heads.numel() / ds.numel()
    assert share == pytest.approx(5 / 9, rel=0.02)


def test_hydrorivers_size_gives_8_5_million_reaches():
    H, W = RIVERS["raster_shape"]
    assert H * W * 5 / 9 == pytest.approx(RIVERS["reaches"], rel=0.01)


DEM = CFG["dem"]
SHAPE = (64, 96)


def test_dem_deterministic_in_metres_on_a_tilt():
    a = generate.relief_dem(SHAPE, DEM, CPU)
    b = generate.relief_dem(SHAPE, DEM, CPU)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    flat = generate.relief_dem(SHAPE, {**DEM, "amp_m_at": [2048, 0.0]}, CPU)
    base, (tr, tc) = DEM["base_m"], DEM["tilt_m_per_cell"]
    assert float(flat[0, 0]) == base  # the tilt alone: down to the lower right
    assert float(flat[63, 95]) == pytest.approx(base - 63 * tr - 95 * tc)


def _octave(lam):
    """The share of the relief (metres) of the octave of wavelength ``lam``
    alone: the DEM of that octave less the tilt alone."""
    one = {**DEM, "octaves_cells": [lam]}
    return (generate.relief_dem(SHAPE, one, CPU)
            - generate.relief_dem(SHAPE, {**one, "octaves_cells": []}, CPU))


@pytest.mark.parametrize("lam", DEM["octaves_cells"])
def test_dem_octave_added_or_removed_changes_no_other(lam):
    """The relief less the same relief without one octave is that octave's
    share alone (to float32 rounding of metres near 1,800): each octave has
    a generator of its own. The share is noise within the octave's
    amplitude."""
    full = generate.relief_dem(SHAPE, DEM, CPU)
    without = generate.relief_dem(
        SHAPE, {**DEM, "octaves_cells": [v for v in DEM["octaves_cells"] if v != lam]}, CPU)
    share = _octave(lam)
    torch.testing.assert_close(full - without, share, rtol=0, atol=1e-3)
    amp = DEM["amp_m_at"][1] * (lam / DEM["amp_m_at"][0]) ** DEM["hurst"]
    assert 0 < float(share.abs().max()) <= amp + 1e-3


@pytest.mark.parametrize("spec,check", [
    ({"dtype": "int32", "fill": "ones"}, lambda x: bool((x == 1).all())),
    ({"dtype": "int32", "fill": "mask", "p": 0.3},
     lambda x: set(x.unique().tolist()) <= {0, 1} and 0.2 < float(x.float().mean()) < 0.4),
    ({"dtype": "float64", "fill": "lognormal", "mu": 0.0, "sigma": 1.0},
     lambda x: bool((x > 0).all())),
])
def test_fields(spec, check):
    x = generate.make_field(spec, 4000, 9, 1, CPU)
    assert x.dtype == getattr(torch, spec["dtype"]) and check(x)
    assert torch.equal(x, generate.make_field(spec, 4000, 9, 1, CPU))


def test_step_fields():
    shape = (20, 30)
    _, ds = generate.scheidegger_d8(shape, CHOICES, 4, CPU)
    step = generate.make_field({"dtype": "int32", "fill": "step"}, 600, 1, 0, CPU, ds=ds)
    assert step.tolist() == (ds != torch.arange(600)).int().tolist()
    m = generate.make_field({"dtype": "float32", "fill": "step_m"}, 600, 1, 0, CPU, ds=ds,
                            shape=shape, geo=CFG["geo"])
    dy = 6371007.0 * math.radians(CFG["geo"]["cellsize_deg"])
    assert bool((m[ds == torch.arange(600)] == 0).all())
    moving = m[ds != torch.arange(600)]
    assert float(moving.min()) > 0.5 * dy and float(moving.max()) < 1.5 * dy
