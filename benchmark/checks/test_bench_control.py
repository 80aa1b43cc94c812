"""The control: the reference one precision lower in the program's place
has to come out as not correct, and the program as correct, at a small size
on the CPU and, on the card, at each cell's own size."""

import pytest
import torch

from benchmark import calibrate, manifest

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _beyond(numbers, limits):
    return [k for k, v in numbers.items() if v > limits[k]]


#: sizes at which the control's float32 paths are long enough to show: a
#: path sum in float32 drifts with the path's length
MID = {"merit3s-tile": {"shape": [600, 800]}, "hydrorivers": {"raster_shape": [300, 300]}}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_small(cell, small_tile_path):
    cfg = manifest.workload(BENCH, cell)["config"]
    row = calibrate.readings(BENCH, cell, 2**31 + 3, torch.device("cpu"), control=True,
                             overrides=MID[cfg])
    lim = manifest.limits(cell)
    assert _beyond(row["program"], lim) == []
    assert _beyond(row["control"], lim)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_on_the_card(cell, card):
    row = calibrate.readings(BENCH, cell, 2**31 + 5, card, control=True)
    lim = manifest.limits(cell)
    assert _beyond(row["program"], lim) == []
    assert _beyond(row["control"], lim)
