"""Self time of autograd's backward per step: each ``train.backward``
span's device time less the part that the ``embed.bwd`` and ``fm.bwd``
device intervals inside it cover (they run on autograd's thread). What
is left are the tower's, the interaction's and the loss's gradients."""

from perfbench.metrics import _spans

LAYER = "tower and interaction (models/graph.py, models/common.py)"
MOVES = "train_examples_per_s"

CHILDREN = ("embed.bwd", "fm.bwd")


def read(ctx):
    backward = _spans.intervals(ctx, ("train.backward",))
    if not backward or ctx.steps <= 0:
        return None
    children = _spans.intervals(ctx, CHILDREN)
    self_us = sum(
        (b - a) - _spans.union_us([c for c in children
                                   if _spans.inside(c, (a, b))])
        for a, b in backward)
    return self_us / 1e3 / ctx.steps
