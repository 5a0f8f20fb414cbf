"""Blocking host-device calls a replayed chunk makes: the program's
``cilium_tpu_engine_host_syncs_total`` at the replay's sites (the
pageable upload, the readback, the auth table), over the
``verdict_chunk`` calls the run made: one a chunk start in the warm-up
(``ctx["step_bytes"]`` holds one entry a start), the window's, and with
a trace the profiler's first call and its traced chunks. A profiler
retry (``trace.trace_chunks``) adds calls this does not count. None
where the program counts none at these sites."""

SITES = ("replay-upload", "host-lanes", "auth-stage")


def read(ctx):
    win, starts = ctx.get("window"), ctx.get("step_bytes")
    if win is None or not starts:
        return None
    try:
        from cilium_tpu_torch.runtime.metrics import (
            ENGINE_HOST_SYNCS,
            METRICS,
        )
    except ImportError:
        return None
    syncs = sum(METRICS.get(ENGINE_HOST_SYNCS, {"site": s}) for s in SITES)
    if syncs <= 0:
        return None
    r = ctx.get("trace")
    calls = len(starts) + win.chunks + (1 + r.chunks if r else 0)
    return syncs / calls
