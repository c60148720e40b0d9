"""Kernel K5 (``ops/flash_attention.py`` → ``csrc/flash_bwd.cu``: the
fused backward, ``flash_bwd_kv_mma`` then ``dq_finalize_kernel``): its
least time at the train step's causal shape (``flops.flash_bwd_bound_s``)
over its mean device time a launch — each part's mean over the records
the trace holds, added — in percent."""

from portbench.flops import flash_bwd_bound_s

PARTS = ("flash_bwd_kv_mma", "dq_finalize")


def read(ctx):
    train, trace = ctx.get("train"), ctx.get("trace")
    if not train or not trace:
        return None
    mean = 0.0
    for part in PARTS:
        recs = [k for n, k in trace["kernels"].items() if part in n]
        count = sum(k["count"] for k in recs)
        if not count:
            return None
        mean += sum(k["seconds"] for k in recs) / count
    return 100.0 * flash_bwd_bound_s(*train["attn_shape"]) / mean
