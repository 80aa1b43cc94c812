"""The tile-plan tests of ``test_torch_tile_tall.py`` on plans of 384-row
tiles (clusters of 3 CTAs on the card): the same grids and checks, in a
module of their own so that parallel workers share the heights out."""

from tests.test_torch_tile_tall import (  # noqa: F401  (collected here)
    plans_fixture,
    test_accumulate_down_int_bitwise,
    test_accumulate_float64_close,
    test_accumulate_int_bitwise,
    test_banded_bitwise,
    test_build_decisions_equal,
    test_composed_indices_equal_the_replayed_jax_tables,
    test_plain_t4_on_the_tree_table_equals_the_jax_passes,
    test_sharded_down_one_rank_bitwise,
    test_tree_table_composes_tree_of_through_rout,
)

plans = plans_fixture((384,))
