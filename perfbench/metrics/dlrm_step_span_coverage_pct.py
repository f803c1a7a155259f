"""Share of DLRM-DCNv2's steps' device time that the layer spans cover:
100 x the union of the ``embed.plan``, ``embed.fwd``, ``bottom.fwd``,
``cross.fwd``, ``tower.fwd``, ``train.loss``, ``train.backward`` and
``train.optimizer`` spans inside a ``train.step`` span, over the
``train.step`` spans' own. Lower means more of a step's work lies
outside any layer's span."""

from perfbench.metrics import _spans

LAYER = "whole step"
MOVES = "train_examples_per_s"

LAYERS = ("embed.plan", "embed.fwd", "bottom.fwd", "cross.fwd",
          "tower.fwd", "train.loss", "train.backward", "train.optimizer")


def read(ctx):
    steps = _spans.intervals(ctx, ("train.step",))
    step_us = sum(b - a for a, b in steps)
    if step_us <= 0:
        return None
    layers = _spans.intervals(ctx, LAYERS)
    covered = sum(
        _spans.union_us([iv for iv in layers if _spans.inside(iv, s)])
        for s in steps)
    return 100.0 * covered / step_us
