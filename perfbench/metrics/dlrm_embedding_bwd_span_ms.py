"""Device time of the embedding backward per step on DLRM-DCNv2: the
``embed.bwd`` spans (each feature's take backward over its plan's
segments)."""

from perfbench.metrics import _spans

LAYER = "embedding (ops/embedding.py, ops/embedding_kernels.py, csrc/embedding.cu)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("embed.bwd",))
