"""Verdicts a second of the window, on the host's clock: every record
whose lanes reached the host, over the window's seconds (first
hand-off to last return). The rate the user of the replay receives."""


def read(ctx):
    w = ctx.get("window")
    if w is None or w.seconds <= 0:
        return None
    return w.verdicts_per_s()
