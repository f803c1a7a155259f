"""The whole step's share of the cards' bfloat16 peak: the model's
operations per example of a training step (the family's count from the
step's shapes, ``flops_per_example``; DeepFM's: forward and backward of
the tower's products) times the traced window's examples per second, over
the peak times the cards."""

LAYER = "whole step"
MOVES = "train_examples_per_s"


def read(ctx):
    peak = ctx.peaks["bf16_flops_per_s"] * ctx.cards
    if ctx.examples_per_s <= 0:
        return None
    return (100.0 * ctx.shapes["flops_per_example"] * ctx.examples_per_s
            / peak)
