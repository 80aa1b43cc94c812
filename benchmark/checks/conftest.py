"""Fixtures of the benchmark's checks.

The CPU checks run the cells at small sizes with the program's plain
versions; ``small_tile_path`` lowers the program's size thresholds so that a
small raster still goes through the tile plan, as the full size does on the
card. The card checks carry the ``cuda`` marker and skip inside the
``card`` fixture where no card is found."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the configurations' keys replaced for the CPU checks
SMALL = {"merit3s-tile": {"shape": [200, 300]}, "hydrorivers": {"raster_shape": [200, 200]}}


@pytest.fixture
def small_tile_path(monkeypatch):
    """The configurations' keys to replace for a small size, with the
    program's thresholds lowered so that the tile plan still runs."""
    from pyflwdir_torch.ops import tile_plan
    from pyflwdir_torch.raster import FlwdirRaster

    monkeypatch.setattr(tile_plan, "_COARSE_ROUTER_MIN", 1)
    monkeypatch.setattr(FlwdirRaster, "_TILE_PLAN_MIN", 1)
    torch.set_num_threads(2)
    return SMALL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the program's kernels run only on the card")
    return torch.device("cuda", 0)
