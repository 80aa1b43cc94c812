"""The tile-plan tests of ``test_torch_tile_plan.py`` on its 256 x 256 grid
with the router coarse levels (``_COARSE_ROUTER_MIN`` lowered in both
packages: the single-chunk router, and with ``_COARSE_SMALL_MAX`` lowered
to 0 the ``BigAccelPlan``), in a module of their own so that parallel
workers share the grids out."""

from tests.test_torch_tile_plan import (  # noqa: F401  (collected here)
    test_accumulate_float64_close,
    test_accumulate_int_bitwise,
    test_build_decisions_equal,
    test_coarse_kernel_indices,
    test_composed_indices_equal_the_replayed_jax_tables,
    test_exits_at_real_roots_bitwise,
    test_plain_pass_c_matches_jax_fused_pass_c,
    test_rin_rout_inverse,
    plans_fixture,
)

plans = plans_fixture(("256x256-router", "256x256-big"))
