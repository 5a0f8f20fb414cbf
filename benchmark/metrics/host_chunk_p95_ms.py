"""The 95th percentile (nearest rank) of every call of the window, each
from the hand-off of its chunk to its host lanes returned."""


def read(ctx):
    w = ctx.get("window")
    if w is None or not w.latencies:
        return None
    return w.p95_ms()
