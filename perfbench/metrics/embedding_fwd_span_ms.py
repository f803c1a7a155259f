"""Device time of the embedding forward per step: the ``embed.fwd`` spans
(the model's lookups, ``models/graph.py``: the batch's dense index and the
gathers of every table's rows)."""

from perfbench.metrics import _spans

LAYER = "embedding (ops/embedding.py, ops/embedding_kernels.py, csrc/embedding.cu)"
MOVES = "train_examples_per_s"


def read(ctx):
    return _spans.per_step_ms(ctx, ("embed.fwd",))
