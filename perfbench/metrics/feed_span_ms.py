"""Device time of the resident feed per step: the ``train.feed`` spans
(``Trainer.fit_device_resident``'s row gathers of a dispatch's batches
from the columns on the card), summed over the window per step."""

from perfbench.metrics import _spans

LAYER = "resident feed (train/loop.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("train.feed",))
