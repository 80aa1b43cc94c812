"""Device operators of the port: DFS plan, router permutations, the
single-chunk router accumulation and pointer-doubling graph primitives."""

from . import accel, graph, plan, router

__all__ = ["accel", "graph", "plan", "router"]
