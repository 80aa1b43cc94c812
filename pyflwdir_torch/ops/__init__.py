"""Device operators of the port: DFS plan, router permutations, the
single-chunk and large-graph router accumulations, the tile plan and
pointer-doubling graph primitives."""

from . import accel, accel_big, graph, plan, router, router_big

__all__ = ["accel", "accel_big", "graph", "plan", "router", "router_big"]
