"""Model step layer, training: the frozen ``train_step_flops`` a step
times the untraced steps of the window, over their time, as a share of
the card's bf16 peak, in percent."""

from portbench.flops import PEAK_BF16_FLOPS


def read(ctx):
    train = ctx.get("train")
    if not train or train["steps"] < 1 or train["seconds"] <= 0:
        return None
    return (100.0 * train["step_flops"] * train["steps"] / train["seconds"]
            / PEAK_BF16_FLOPS)
