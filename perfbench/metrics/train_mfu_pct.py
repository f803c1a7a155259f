"""The whole step's share of the cards' bfloat16 peak: the model's
operations per example (forward and backward of the tower's products,
counted from shapes here) times the traced window's examples per second,
over the peak times the cards."""

LAYER = "whole step"
MOVES = "train_examples_per_s"


def flops_per_example(s):
    dims = s["tower"]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:])) + dims[-1]
    return 6 * macs


def read(ctx):
    peak = ctx.peaks["bf16_flops_per_s"] * ctx.cards
    if ctx.examples_per_s <= 0:
        return None
    return 100.0 * flops_per_example(ctx.shapes) * ctx.examples_per_s / peak
