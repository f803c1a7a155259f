"""Device time of the embedding backward per step: the ``embed.bwd`` spans
(``IndexRows`` and ``TakeRowsSum``'s backward, the segments they build
included), whatever kernels do that work."""

from perfbench.metrics import _spans

LAYER = "embedding (ops/embedding.py, ops/embedding_kernels.py, csrc/embedding.cu)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("embed.bwd",))
