"""Device operators of the port: DFS plan, router permutations, the
single-chunk and large-graph router accumulations, the tile plan and its
files on disk, pointer-doubling graph primitives, stencils, stream order,
window gathers and walks, and the depression fill."""

from . import (accel, accel_big, fill, graph, order, plan, plan_io, router, router_big,
               stencil, tile_plan, walk)
from .graph import (
    accumulate,
    accumulate_downstream,
    confluence_indices,
    fillnodata_downstream,
    fillnodata_upstream,
    flwdir_tuples,
    headwater_indices,
    idxs_seq,
    loop_indices,
    main_upstream,
    path_reduce,
    path_sum,
    pit_indices,
    pit_mask,
    propagate_downstream,
    rank,
    reach,
    roots,
    self_loop,
    upstream_count,
    upstream_matrix,
    valid_mask,
)

__all__ = ["accel", "accel_big", "fill", "graph", "order", "plan", "plan_io", "router",
           "router_big", "stencil", "tile_plan", "walk", "accumulate",
           "accumulate_downstream", "confluence_indices", "fillnodata_downstream",
           "fillnodata_upstream", "flwdir_tuples", "headwater_indices", "idxs_seq",
           "loop_indices", "main_upstream", "path_reduce", "path_sum", "pit_indices",
           "pit_mask", "propagate_downstream", "rank", "reach", "roots", "self_loop",
           "upstream_count", "upstream_matrix", "valid_mask"]
