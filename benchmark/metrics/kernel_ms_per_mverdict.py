"""Kernel time on the card for a million verdicts: the summed device
time of every kernel the traced chunks launched (the capture step, and
the casts of the replay's readback), over the records those chunks
hold. What a replay costs the card's compute, whatever the host does
meanwhile; its inverse is the rate one card sustains when its host
keeps it fed."""


def read(ctx):
    r = ctx.get("trace")
    if r is None or r.kernels == 0 or not ctx.get("chunk"):
        return None
    return r.kernel_s * 1e3 / (r.chunks * ctx["chunk"] / 1e6)
