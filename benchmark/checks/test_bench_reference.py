"""The plain reference on tiny hand-made cases, the D8 certificate, and the
least-bytes count of the roofline."""

import math

import pytest
import torch

from benchmark import reference, roofline

# 0 -> 2, 1 -> 2, 2 -> 3, 3 -> 3 (outlet), 4 -> 3
DS = torch.tensor([2, 2, 3, 3, 3])
X = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0], dtype=torch.float64)


def test_depths_and_levels():
    assert reference.depths(DS).tolist() == [2, 2, 1, 0, 1]
    lv = reference.Levels(DS)
    assert lv.n_levels == 3
    assert sorted(lv.level(1).tolist()) == [2, 4]


@pytest.mark.parametrize("ds", [[1, 0, 2], [1, 2, 0, 3], [1, 1, 3, 2]])
def test_depths_raise_on_a_cycle(ds):
    with pytest.raises(ValueError):
        reference.depths(torch.tensor(ds))


def test_up_and_down_by_hand():
    lv = reference.Levels(DS)
    assert lv.up(X).tolist() == [1.0, 2.0, 7.0, 31.0, 16.0]
    assert lv.down(X).tolist() == [13.0, 14.0, 12.0, 8.0, 24.0]
    two = torch.stack([X, 2 * X], 1)
    assert lv.up(two)[:, 1].tolist() == [2.0, 4.0, 14.0, 62.0, 32.0]


def test_reference_sweeps_precision_and_control():
    lv = reference.Levels(DS)
    fields = [torch.ones(5, dtype=torch.int32), X, X.to(torch.float32)]
    refs = reference.reference_sweeps(lv, "up", fields)
    assert refs[0].dtype == torch.int64 and refs[0].tolist() == [1, 1, 3, 5, 1]
    assert refs[1].dtype == torch.float64 and refs[2].dtype == torch.float64
    ctrl = reference.reference_sweeps(lv, "up", fields, control=True)
    assert ctrl[1].dtype == torch.float32 and ctrl[0].dtype == torch.int64


def test_compare_sweeps_counts_and_gaps():
    lv = reference.Levels(DS)
    fields = [torch.ones(5, dtype=torch.int32), X]
    refs = reference.reference_sweeps(lv, "up", fields)
    good = [refs[0].to(torch.int32), refs[1].clone()]
    assert reference.compare_sweeps("up", good, [0, 1], refs, fields) == {
        "int_cells_off": 0, "float_gap_of_total": 0.0}
    bad = [good[0].clone(), good[1].clone()]
    bad[0][3] += 1
    bad[1][2] += 0.31
    nums = reference.compare_sweeps("up", bad, [0, 1], refs, fields)
    assert nums["int_cells_off"] == 1
    assert nums["float_gap_of_total"] == pytest.approx(0.31 / 31.0)
    down = reference.reference_sweeps(lv, "down", fields)
    d = [down[0].to(torch.int32), down[1] * (1 + 1e-6)]
    assert reference.compare_sweeps("down", d, [0, 1], down, fields)["float_rel_gap"] == (
        pytest.approx(1e-6))


def _ds(shape, rule):
    """Raster-order downstream ids: ``rule`` maps cells to their downstream
    cells, every other cell is an outlet."""
    ds = torch.arange(shape[0] * shape[1])
    for i, j in rule.items():
        ds[i] = j
    return ds


# 3x3: a bowl at the centre (1 m) that spills over the lower edge's middle
# cell (5 m): filled, the centre stands at 5 and flows over the flat to it;
# the other edge cells (9 m) drain to their steepest lower neighbour
BOWL = torch.tensor([[9.0, 9.0, 9.0],
                     [9.0, 1.0, 9.0],
                     [9.0, 5.0, 9.0]])
GOOD = {0: 4, 1: 4, 2: 4, 3: 4, 5: 4, 6: 7, 8: 7, 4: 7}


def test_certificate_accepts_the_filled_drainage():
    counts = reference.judge_d8(BOWL, _ds((3, 3), GOOD))
    assert sum(counts.values()) == 0, counts


@pytest.mark.parametrize("change,broken", [
    ({4: 4}, "pit_inland"),  # the bowl left as a pit
    ({4: 1}, "not_filled_surface"),  # out over the rim at 9 m
    ({7: 4}, "cycle"),
    ({0: 8}, "not_a_neighbour"),
    ({6: 3}, "not_steepest"),  # level along the edge, not down to 7
    ({6: 4}, "not_steepest"),  # 4 m over a diagonal, not 4 m over one
])
def test_certificate_flags(change, broken):
    counts = reference.judge_d8(BOWL, _ds((3, 3), {**GOOD, **change}))
    assert counts[broken] > 0, counts


def test_certificate_flags_an_edge_outlet_that_drains():
    z = torch.tensor([[0.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 0.0]])
    assert sum(reference.judge_d8(z, _ds((3, 3), {4: 1})).values()) == 0
    z[2, 2] = 1.0
    counts = reference.judge_d8(z, _ds((3, 3), {4: 1}))
    assert counts["pit_drains"] == 1  # cell 8 (1 m) has lower neighbours


def test_certificate_wants_the_steepest_neighbour():
    # edges at 0; each inner cell's steepest way is over one cell to an edge
    z = torch.zeros(4, 4)
    z[1, 1], z[1, 2], z[2, 1], z[2, 2] = 4.0, 3.0, 2.0, 5.0
    steep = {5: 1, 6: 2, 9: 13, 10: 14}
    assert sum(reference.judge_d8(z, _ds((4, 4), steep)).values()) == 0
    assert sum(reference.judge_d8(z, _ds((4, 4), {**steep, 5: 4})).values()) == 0  # a tie
    counts = reference.judge_d8(z, _ds((4, 4), {**steep, 5: 6}))
    assert counts["not_steepest"] == 1


def test_least_bytes_of_a_sweep():
    tile = {"kind": "raster"}
    net = {"kind": "network"}
    n = 36_000_000
    assert roofline.sweep_bytes(tile, n, torch.int32, torch.int32) == n * 9
    assert roofline.sweep_bytes(tile, n, torch.float64, torch.float64) == n * 17
    assert roofline.sweep_bytes(tile, n, torch.float32, torch.float32) == n * 9
    assert roofline.link_bytes(net, 8_500_000) == 3
    assert roofline.link_bytes(net, 2**16) == 2
    assert roofline.link_bytes(net, 2**16 + 1) == 3
    assert roofline.sweep_bytes(net, 8_500_000, torch.float64, torch.float64) == 8_500_000 * 19


def test_published_peak():
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_bytes_per_s("some other card") is None
    assert math.isclose(36e6 * 9 / 3.35e12 * 1e3, 0.0967, rel_tol=1e-3)
