"""Device time of the optimizer per step on DLRM-DCNv2: the
``train.optimizer`` spans (exact Adagrad on the dense parameters, then
each table's touched rows: gathers, update and writeback)."""

from perfbench.metrics import _spans

LAYER = "optimizer (train/optimizers.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("train.optimizer",))
