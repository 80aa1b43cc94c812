"""Seconds of the plan build in set-up (host span, synchronised at both
ends): the tile plan and its device tables, with the downward indices where
the cell sweeps down; the DFS and router plans of a network."""


def read(ctx):
    return ctx.spans.get("plan_build")
