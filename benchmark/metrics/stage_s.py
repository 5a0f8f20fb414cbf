"""The harness's span around the replay's staging: the capture opened,
its string tables scanned on the card, the rows featurized, the dedup
tried."""


def read(ctx):
    return ctx.get("spans", {}).get("stage_s")
