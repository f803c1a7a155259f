"""Device time of the MLPs' forward per step on DLRM-DCNv2: the bottom
MLP's ``bottom.fwd`` and the top MLP's ``tower.fwd`` spans (its layers and
head)."""

from perfbench.metrics import _spans

LAYER = "tower and interaction (models/graph.py, models/common.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("bottom.fwd", "tower.fwd"))
