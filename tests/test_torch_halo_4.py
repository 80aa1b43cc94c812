"""The halo runtime tests of ``test_torch_halo.py`` on a world of 4 gloo
ranks (a (2, 2) mesh) against the JAX functions on a 4-device virtual mesh,
in a module of their own so that parallel workers share the worlds out."""

from tests.test_torch_halo import (  # noqa: F401  (collected here)
    test_accumulate_rules,
    test_exit_slot_overflow_raises,
    test_fill_matches_host,
    test_guards_fire_where_the_jax_ones_do,
    test_halo_matches_jax,
    test_mesh_layout,
    test_strahler_matches_native,
    halo_fixtures,
)

halo, world = halo_fixtures((4,))
