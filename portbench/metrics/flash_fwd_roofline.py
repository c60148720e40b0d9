"""Kernel K1 (``ops/flash_attention.py`` → ``csrc/flash_fwd.cu``
``flash_fwd_mma``): its least time at the train step's causal shape
(``flops.flash_fwd_bound_s``) over its mean device time a launch, from
the records the trace holds, in percent."""

from portbench.flops import flash_fwd_bound_s

KERNEL = "flash_fwd_mma"


def read(ctx):
    train, trace = ctx.get("train"), ctx.get("trace")
    if not train or not trace:
        return None
    recs = [k for n, k in trace["kernels"].items() if KERNEL in n]
    count = sum(k["count"] for k in recs)
    if not count:
        return None
    mean = sum(k["seconds"] for k in recs) / count
    return 100.0 * flash_fwd_bound_s(*train["attn_shape"]) / mean
