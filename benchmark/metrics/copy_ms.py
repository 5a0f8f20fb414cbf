"""Device time of the copies a chunk makes (the rows' upload, the
lanes' readback), averaged over the traced chunks."""


def read(ctx):
    r = ctx.get("trace")
    if r is None or r.copy_s == 0:
        return None
    return r.copy_s / r.chunks * 1e3
