"""Share of the traced sub-window in which no kernel, copy or fill ran
on the card."""


def read(ctx):
    r = ctx.get("trace")
    if r is None or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
