"""Device time of the embedding forward per step on DLRM-DCNv2: the
``embed.fwd`` spans (the touched rows' gathers, each feature's take
forward and its bag sums, the ``embed.pool`` spans inside)."""

from perfbench.metrics import _spans

LAYER = "embedding (ops/embedding.py, ops/embedding_kernels.py, csrc/embedding.cu)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("embed.fwd",))
