"""Device time of the cross network's forward per step on DLRM-DCNv2: the
``cross.fwd`` spans (the concatenation and the low-rank layers). Its
backward runs inside ``train.backward``."""

from perfbench.metrics import _spans

LAYER = "tower and interaction (models/graph.py, models/common.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("cross.fwd",))
