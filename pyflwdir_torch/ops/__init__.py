"""Device operators of the port: DFS plan, router permutations, the
single-chunk and large-graph router accumulations, the tile plan,
pointer-doubling graph primitives and the depression fill."""

from . import accel, accel_big, fill, graph, plan, router, router_big

__all__ = ["accel", "accel_big", "fill", "graph", "plan", "router", "router_big"]
