"""Device time of the FM block per step: its forward (``fm.fwd``,
``fm_block``) and backward (``fm.bwd``, ``FusedFM.backward``) spans."""

from perfbench.metrics import _spans

LAYER = "FM (ops/fused_fm.py, csrc/fused_fm.cu)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("fm.fwd", "fm.bwd"))
