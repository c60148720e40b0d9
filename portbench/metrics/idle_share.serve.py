"""Device layer, serve cells: the share of the traced window in which no
operation ran on the card, 1 − (union of the device operations'
intervals) / (traced window), in percent."""


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "serve" or not trace or trace["window_s"] <= 0:
        return None
    if trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
