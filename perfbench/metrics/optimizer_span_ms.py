"""Device time of the optimizer per step: the ``train.optimizer`` spans
(the pad rows' gradient mask and the Adam apply of every leaf)."""

from perfbench.metrics import _spans

LAYER = "optimizer (train/optimizers.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("train.optimizer",))
