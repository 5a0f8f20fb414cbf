"""The harness's span around the loader's regeneration: the resolved
policy compiled (or read from the artifact cache) and staged on the
card."""


def read(ctx):
    return ctx.get("spans", {}).get("regen_s")
