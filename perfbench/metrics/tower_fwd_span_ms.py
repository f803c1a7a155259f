"""Device time of the tower's forward per step: the ``tower.fwd`` spans
(the tower's input, its interaction where the model has one, its layers
and head)."""

from perfbench.metrics import _spans

LAYER = "tower and interaction (models/graph.py, models/common.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("tower.fwd",))
