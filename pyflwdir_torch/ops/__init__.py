"""Device operators of the port: DFS plan, router permutations, the
single-chunk and large-graph router accumulations, the tile plan and its
files on disk, pointer-doubling graph primitives, stream order, window
gathers and walks, and the depression fill."""

from . import (accel, accel_big, fill, graph, order, plan, plan_io, router, router_big,
               tile_plan, walk)

__all__ = ["accel", "accel_big", "fill", "graph", "order", "plan", "plan_io", "router",
           "router_big", "tile_plan", "walk"]
