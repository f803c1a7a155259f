"""Device time of the resident feed per step on DLRM-DCNv2: the
``train.feed`` spans (the row gathers of a dispatch's batches, 227
columns a row), summed over the window per step."""

from perfbench.metrics import _spans

LAYER = "resident feed (train/loop.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("train.feed",))
