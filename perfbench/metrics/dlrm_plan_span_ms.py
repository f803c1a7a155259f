"""Device time of the sparse update's plans per step on DLRM-DCNv2: the
``embed.plan`` spans (every feature's dedup, on the counting kernel or the
sort leg, and the position segments)."""

from perfbench.metrics import _spans

LAYER = "embedding (ops/embedding.py, ops/embedding_kernels.py, csrc/embedding.cu)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("embed.plan",))
