"""The banded-sweep tests of ``test_torch_tile_banded.py`` on its 256 x 256
grid with the router coarse levels (the single-chunk router and the
``BigAccelPlan``), in a module of their own so that parallel workers share
the grids out."""

from tests.test_torch_tile_banded import (  # noqa: F401  (collected here)
    test_banded_float64_close,
    test_banded_int_bitwise,
    test_banded_leaves_the_tables_on_the_host,
    test_unfused_passes_match_jax_tiles,
    plans_fixture,
)

plans = plans_fixture(("256x256-router", "256x256-big"))
