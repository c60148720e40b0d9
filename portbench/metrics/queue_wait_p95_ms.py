"""Admission layer: the 95th percentile of each request's wait from its
due time to the engine's ``pop`` of it (the benchmark's admission
source), over every request of the window."""

from portbench.flops import percentile


def read(ctx):
    serve = ctx.get("serve")
    if not serve or not serve["queue_wait_ms"]:
        return None
    return percentile(serve["queue_wait_ms"], 95)
